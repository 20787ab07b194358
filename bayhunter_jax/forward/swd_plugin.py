"""Surface-wave dispersion plugin (host API around ops/swd.py).

Drop-in equivalent of the reference's f2py wrapper ``SurfDisp``
(reference: src/surf96_modsw.py:13-126): same constructor signature,
``set_modelparams``, target-ref tags and ``run_model`` contract
(returns ``(nan, nan)`` on solver failure).  The >60-period
resample-to-60-then-interpolate behavior of the reference is
reproduced for parity (reference: src/surf96_modsw.py:35-43,106-122).
"""

import numpy as np
import jax.numpy as jnp

from bayhunter_jax.ops.swd import surfdisp

# The reference Fortran caps models at 100 layers (surfdisp96.f:60);
# padding host calls to one fixed width keeps a single XLA compilation.
NL_HOST = 100


class SurfDisp(object):
    """Forward modeling of dispersion curves (JAX surf96
    equivalent)."""

    def __init__(self, obsx, ref):
        self.obsx = np.asarray(obsx, float)
        self.kmax = self.obsx.size
        self.ref = ref

        self.modelparams = {
            'mode': 1,   # 1 fundamental, 2 first higher
            'flsph': 0,  # 0 flat earth, 1 spherical
        }
        self.wavetype, self.veltype = self.get_surftags(ref)

        if self.kmax > 60:
            self.obsx_int = np.linspace(self.obsx.min(), self.obsx.max(),
                                        60)

    def set_modelparams(self, **mparams):
        self.modelparams.update(mparams)

    def get_surftags(self, ref):
        """(iwave, igr) per target ref
        (reference: src/surf96_modsw.py:48-66)."""
        tags = {'rdispgr': (2, 1), 'ldispgr': (1, 1),
                'rdispph': (2, 0), 'ldispph': (1, 0)}
        if ref not in tags:
            raise ReferenceError(
                "Reference %s not available in SurfDisp. Available: "
                "rdispgr, ldispgr, rdispph, ldispph "
                "(r=rayleigh, l=love, gr=group, ph=phase)" % ref)
        return tags[ref]

    def get_modelvectors(self, h, vp, vs, rho):
        """Pad to the fixed solver width, halfspace replicated
        (see ops/voronoi.py padding convention)."""
        n = len(h)
        out = []
        for arr, fill_hs in ((h, False), (vp, True), (vs, True),
                             (rho, True)):
            arr = np.asarray(arr, float)
            vec = np.full(NL_HOST, arr[-1] if fill_hs else 0.0)
            vec[:n] = arr
            if not fill_hs:
                vec[n - 1:] = 0.0  # thickness: halfspace & padding
            out.append(vec)
        return out

    def run_model(self, h, vp, vs, rho, **params):
        """Forward dispersion for one layered model; returns (x, y) or
        (nan, nan) on failure (reference: src/surf96_modsw.py:84-126)."""
        h4, vp4, vs4, rho4 = self.get_modelvectors(h, vp, vs, rho)

        if self.kmax > 60:
            pers = self.obsx_int
        else:
            pers = self.obsx

        cg, err = surfdisp(
            jnp.asarray(h4), jnp.asarray(vp4), jnp.asarray(vs4),
            jnp.asarray(rho4), jnp.asarray(pers),
            iwave=self.wavetype, igr=self.veltype,
            mode=self.modelparams['mode'],
            iflsph=self.modelparams['flsph'])
        if bool(err):
            return np.nan, np.nan
        cg = np.asarray(cg)
        if self.kmax > 60:
            return self.obsx, np.interp(self.obsx, pers, cg)
        return pers, cg
