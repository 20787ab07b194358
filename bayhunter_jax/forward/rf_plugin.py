"""Receiver-function plugin (host API around ops/rf.py).

Drop-in equivalent of the reference's Cython wrapper ``RFminiModRF``
(reference: src/rfmini_modrf.py:13-154): derives fsamp/tshift/nsamp
from the observed time axis, defaults Qp=500/Qs=225, computes the
rotation velocities from the top layer (or an explicit ``nsv``), and
returns the synthetic RF trimmed to the observed samples.
"""

import numpy as np
import jax.numpy as jnp

from bayhunter_jax.ops.rf import (synrf, coeff, coeffs,  # noqa: F401
                                  P_WAVE, SV_WAVE)
# coeff/coeffs re-exported for rfmini API parity
# (reference: rfmini.pyx:252-331)

NL_HOST = 100  # fixed host-call padding width (single compilation)


class SynRF(object):
    """Forward modeling of receiver functions (JAX rfmini
    equivalent)."""

    def __init__(self, obsx, ref):
        self.ref = ref
        self.obsx = np.asarray(obsx, float)
        self._init_obsparams()

        if self.ref in ['prf', 'seis']:
            self.modelparams = {'wtype': 'P'}
        elif self.ref in ['srf']:
            self.modelparams = {'wtype': 'SV'}
        else:
            self.modelparams = {'wtype': 'P'}

        self.modelparams.update({
            'gauss': 1.0,   # Gauss low-pass parameter a
            'p': 6.4,       # slowness in s/deg
            'water': 0.001,  # accepted for parity; see ops/rf.py notes
            'nsv': None,    # near-surface S velocity for rotation
        })

    def _init_obsparams(self):
        """fsamp/tshft/nsamp from the observed time vector
        (reference: src/rfmini_modrf.py:41-62)."""
        deltas = np.round(self.obsx[1:] - self.obsx[:-1], 4)
        if np.unique(deltas).size != 1:
            raise ValueError("Target: %s. Sampling rate must be constant."
                             % self.ref)
        dt = float(deltas[0])
        self.fsamp = 1.0 / dt
        self.tshft = -self.obsx[0]
        ndata = self.obsx.size
        self.nsamp = int(2 ** np.ceil(np.log2(ndata * 2)))

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def write_startmodel(self, h, vp, vs, rho, modfile, **params):
        """ASCII model file writer (reference: src/rfmini_modrf.py:64-94)."""
        h = np.asarray(h, float)
        qp = np.asarray(params.get('qp', np.ones(h.size) * 500.))
        qs = np.asarray(params.get('qs', np.ones(h.size) * 225.))
        z = np.cumsum(h)
        z = np.concatenate(([0], z[:-1]))
        fmt = {'z': '%.2f', 'vp': '%.4f', 'vs': '%.4f', 'rho': '%.4f',
               'qp': '%.1f', 'qs': '%.1f'}
        cols = [('z', z), ('vp', vp), ('vs', vs), ('rho', rho),
                ('qp', qp), ('qs', qs)]
        cols = [(k, np.asarray(v, float)) for k, v in cols
                if v is not None]
        with open(modfile, 'w') as f:
            f.write('\t'.join(k for k, _ in cols) + '\n')
            line = '\t'.join(fmt[k] for k, _ in cols) + '\n'
            for i in range(z.size):
                f.write(line % tuple(v[i] for _, v in cols))

    def _pad(self, h, vp, vs, rho, qp, qs):
        n = len(h)
        out = []
        for arr, fill_hs in ((h, False), (vp, True), (vs, True),
                             (rho, True), (qp, True), (qs, True)):
            arr = np.asarray(arr, float)
            vec = np.full(NL_HOST, arr[-1] if fill_hs else 0.0)
            vec[:n] = arr
            if not fill_hs:
                vec[n - 1:] = 0.0
            out.append(vec)
        return out

    def compute_rf(self, h, vp, vs, rho, **params):
        """Synthetic receiver function for one layered model
        (reference: src/rfmini_modrf.py:99-142)."""
        gauss = self.modelparams['gauss']
        p = self.modelparams['p']
        wtype = self.modelparams['wtype']
        nsv = self.modelparams['nsv']

        qp = params.get('qp', np.ones(len(h)) * 500.)
        qs = params.get('qs', np.ones(len(h)) * 225.)

        nsvp, nsvs = float(vp[0]), float(vs[0])
        vpvs = nsvp / nsvs
        poisson = (2 - vpvs ** 2) / (2 - 2 * vpvs ** 2)
        if nsv is None:
            nsv = nsvs

        time = np.arange(self.nsamp) / self.fsamp - self.tshft

        hp, vpp, vsp, rhop, qpp, qsp = self._pad(h, vp, vs, rho, qp, qs)
        wave = P_WAVE if wtype == 'P' else SV_WAVE
        fz, fr, qrf = synrf(
            jnp.asarray(hp), jnp.asarray(vpp), jnp.asarray(vsp),
            jnp.asarray(rhop), jnp.asarray(qpp), jnp.asarray(qsp),
            p, gauss, self.nsamp, self.fsamp, self.tshft,
            nsv, poisson, wave_type=wave)

        qrfdata = np.asarray(qrf, float)
        return time[:self.obsx.size], qrfdata[:self.obsx.size]

    def run_model(self, h, vp, vs, rho, **params):
        h = np.asarray(h, float)
        vp = np.asarray(vp, float)
        vs = np.asarray(vs, float)
        rho = np.asarray(rho, float)
        assert h.size == vp.size == vs.size == rho.size
        return self.compute_rf(h, vp, vs, rho, **params)
