"""Tomography-scale batched inversions: many independent datasets
("cells" of a velocity map) x many chains each, as ONE device program.

The reference can only invert one station per process-pool run; here a
(ncells, ndata) observation matrix rides the same chain batch axis —
each chain carries a ``cell`` index selecting its observed row
(evaluator.py), so a 1k-cell x 100-chain ambient-noise map inversion
is a single 100k-chain batch sharded over the device mesh
(BASELINE.json config "Tomography-scale").
"""

import logging
import time

import numpy as np
import jax
from jax.sharding import Mesh

from bayhunter_jax import Targets, device
from bayhunter_jax.config import load_params, get_path
from bayhunter_jax.parallel.mesh import pad_chains, shard_states
from bayhunter_jax.sampler.chain import (build_sampler,
                                         dispatch_cycles, make_config)
from bayhunter_jax.sampler.evaluator import build_evaluator

logger = logging.getLogger(__name__)

TARGET_CLASSES = {
    'rdispph': Targets.RayleighDispersionPhase,
    'rdispgr': Targets.RayleighDispersionGroup,
    'ldispph': Targets.LoveDispersionPhase,
    'ldispgr': Targets.LoveDispersionGroup,
}


class TomoInversion(object):
    """Joint inversion of ``ncells`` independent dispersion curves.

    Parameters
    ----------
    x : (ndata,) periods
    Y : (ncells, ndata) observed dispersion matrix
    ref : one of rdispph / rdispgr / ldispph / ldispgr
    chains_per_cell : chains allocated to every cell
    priors / initparams : reference-style dicts (defaults.ini filled in)
    """

    def __init__(self, x, Y, ref='rdispph', chains_per_cell=32,
                 priors=None, initparams=None, random_seed=None,
                 dtype=None, devices=None):
        import jax.numpy as jnp
        dtype = dtype or jnp.float32
        Y = np.atleast_2d(np.asarray(Y, float))
        self.ncells = Y.shape[0]
        self.chains_per_cell = int(chains_per_cell)

        self.priors, self.initparams = load_params(
            get_path('defaults.ini'))
        self.priors.update(priors or {})
        self.initparams.update(initparams or {})

        target = TARGET_CLASSES[ref](np.asarray(x, float), Y)
        self.joint = Targets.JointTarget(targets=[target])

        nl = int(self.priors['layers'][1]) + 1
        self.cfg = make_config(self.priors, self.initparams, ['swd'],
                               nl=nl, dtype=dtype)
        devs = devices if devices is not None else jax.devices()
        platform, kind, ndev = device.describe(devs)
        logger.info('tomo devices: platform %s, %s x %d'
                    % (platform, kind, ndev))
        device.enable_compile_cache()
        self.eval_fn = build_evaluator(self.joint, self.priors,
                                       self.initparams, nl, dtype=dtype)
        # multi-device: shard_map the dispatch programs (each shard's
        # root-search loops stop on their own; chain.build_sampler)
        mesh = (Mesh(np.array(devs), ('chains',))
                if len(devs) > 1 else None)
        self.sampler = build_sampler(self.eval_fn, self.cfg, mesh=mesh)

        self.devices = devices
        self.nchains = self.ncells * self.chains_per_cell
        self.nchains_padded = pad_chains(self.nchains, devices)
        self.seed = (random_seed if random_seed is not None
                     else np.random.RandomState().randint(2 ** 31))

    def run(self, segment_iters=200, log_every=5):
        """Run burn-in + main over all cells; returns a dict with the
        final states and per-cell posterior summaries."""
        cells = np.repeat(np.arange(self.ncells),
                          self.chains_per_cell)
        cells = np.resize(cells, self.nchains_padded)
        states = self.sampler.init_states_host(self.seed,
                                               self.nchains_padded,
                                               cells=cells)
        states = shard_states(states, self.devices)

        total = (int(self.initparams['iter_burnin'])
                 + int(self.initparams['iter_main']))
        t0 = time.time()
        done = 0
        seg_i = 0
        smp = self.sampler
        it_global = -int(self.initparams['iter_burnin'])
        while done < total:
            k = min(segment_iters, total - done)
            # production dispatch: fused move cycles (see
            # sampler/chain.py dispatch_cycles)
            states = dispatch_cycles(smp, states, it_global, k)
            done += k
            it_global += k
            seg_i += 1
            if seg_i % log_every == 0 or done >= total:
                jax.block_until_ready(states.logL)
                rate = done * self.nchains_padded / (time.time() - t0)
                logger.info('tomo %7d/%d it | %.0f proposals/s '
                            '| logL med %.1f'
                            % (done, total, rate,
                               float(np.median(np.asarray(
                                   states.logL)))))
        self.final_states = states
        return self.summarize(states)

    def summarize(self, states):
        """Per-cell posterior summary from the final chain states:
        median/mean Vs profile on a regular depth grid plus noise."""
        vs = np.asarray(states.vs)[:self.nchains]
        z = np.asarray(states.z)[:self.nchains]
        n = np.asarray(states.n)[:self.nchains]
        vpvs = np.asarray(states.vpvs)[:self.nchains]
        noise = np.asarray(states.noise)[:self.nchains]
        logL = np.asarray(states.logL)[:self.nchains]

        zmax = float(self.priors['z'][1])
        dep_int = np.linspace(0.0, zmax, 121)
        prof = np.empty((self.nchains, dep_int.size))
        for c in range(self.nchains):
            # nearest-nucleus profile (the Voronoi-cell definition,
            # reference: src/Models.py:16-52)
            zc = z[c][:n[c]]
            vc = vs[c][:n[c]]
            idx = np.abs(dep_int[:, None] - zc[None, :]).argmin(axis=1)
            prof[c] = vc[idx]

        prof = prof.reshape(self.ncells, self.chains_per_cell, -1)
        noise_c = noise.reshape(self.ncells, self.chains_per_cell, -1)
        logL_c = logL.reshape(self.ncells, self.chains_per_cell)
        return {
            'depth': dep_int,
            'vs_median': np.median(prof, axis=1),
            'vs_mean': prof.mean(axis=1),
            'vs_std': prof.std(axis=1),
            'noise_median': np.median(noise_c, axis=1),
            'logL_median': np.median(logL_c, axis=1),
        }
