"""Batched joint-target evaluator for the on-device sampler.

Builds, from a host-side ``JointTarget``, a pure function
``eval_fn(vs, z, n, vpvs, noise) -> (logL, misfits, valid)`` evaluating
one (masked, fixed-shape) Voronoi model against every target — the
device equivalent of ``JointTarget.evaluate``
(reference: src/Targets.py:314-347), including the sentinel semantics
(logL=-1e15, misfits=1e15 on any invalid forward output).

The covariance law per target is fixed at build time following the
reference's dispatch (reference: src/SingleChain.py:159-205):
  * corr inverted for            -> exponential law (matrix-free)
  * corr fixed to 0, NaN yerr    -> diagonal
  * corr fixed to 0, real yerr   -> diagonal with scaled errors
  * corr fixed nonzero, RF       -> Gaussian law (dense inverse
                                    precomputed ONCE on the host with
                                    optional rcond pinv)
  * corr fixed nonzero, otherwise-> exponential law
"""

import logging
import typing

import numpy as np
import jax.numpy as jnp

from bayhunter_jax.ops import likelihood as lk
from bayhunter_jax.ops.rf import synrf, P_WAVE, SV_WAVE
from bayhunter_jax.ops.swd import surfdisp_roots
from bayhunter_jax.ops.voronoi import voronoi_to_layers

logger = logging.getLogger(__name__)


class EvalBundle(typing.NamedTuple):
    """Joint-target evaluators sharing a forward cache.

    The cache (one per chain) is a tuple over targets of
    ``(y_synth, roots)`` — the synthetic data of the *current* model
    and, for SWD targets, the dispersion roots used to warm-start the
    next solve.  ``roots`` is a zero-length array for RF targets.

      eval_full(vs, z, n, vpvs, noise, cache)
          -> (logL, misfits, valid, new_cache)   # warm-started
      eval_cold(vs, z, n, vpvs, noise)
          -> (logL, misfits, valid, new_cache)   # full root search
      eval_noise(noise, cache) -> (logL, valid)  # reuses cached y;
          misfits are unchanged by noise moves by construction
    """
    eval_full: typing.Callable
    eval_cold: typing.Callable
    eval_noise: typing.Callable
    ntargets: int
    specs: list

    # old 3-output protocol (cold start), for convenience in tests
    def __call__(self, vs, z, n, vpvs, noise):
        logL, misfits, valid, _ = self.eval_cold(vs, z, n, vpvs, noise)
        return logL, misfits, valid

SWD_REFS = {'rdispph': (2, 0), 'ldispph': (1, 0),
            'rdispgr': (2, 1), 'ldispgr': (1, 1)}
RF_REFS = {'prf': P_WAVE, 'srf': SV_WAVE}

LOGL_SENTINEL = -1e15
MISFIT_SENTINEL = 1e15

def _covariance_kind(target, corr_fixed, corr_value):
    """Reference: src/SingleChain.py:159-205."""
    if not corr_fixed:
        return 'exp'
    if corr_value == 0 and np.any(np.isnan(target.obsdata.yerr)):
        return 'nocorr'
    if corr_value == 0:
        return 'nocorr_scalederr'
    if getattr(target, 'noiseref', 'swd') == 'rf':
        return 'gauss'
    return 'exp'


class _TargetSpec:
    """Host-precomputed constants for one target."""

    def __init__(self, target, corr_fixed, corr_value, rcond, dtype,
                 dof_correction=False):
        self.ref = target.ref
        self.kind = 'swd' if target.ref in SWD_REFS else \
            'rf' if target.ref in RF_REFS else 'custom'
        # observed data may be (ndata,) for one station, or
        # (ncells, ndata) for tomography-scale batched inversions —
        # each chain then selects its row via its ``cell`` index
        yobs = np.asarray(target.obsdata.y)
        self.batched_obs = yobs.ndim == 2
        self.yobs = jnp.asarray(yobs, dtype)
        self.ndata = int(yobs.shape[-1])
        self.cov = _covariance_kind(target, corr_fixed, corr_value)

        plugin = target.moddata.plugin
        if self.kind == 'swd':
            self.iwave, self.igr = SWD_REFS[target.ref]
            self.mode = int(plugin.modelparams.get('mode', 1))
            self.flsph = int(plugin.modelparams.get('flsph', 0))
            obsx = np.asarray(target.obsdata.x, float)
            if obsx.size > 60:
                # reference 60-period cap + interpolation
                # (src/surf96_modsw.py:35-43,106-122)
                self.periods = jnp.asarray(
                    np.linspace(obsx.min(), obsx.max(), 60), dtype)
                self.interp_x = jnp.asarray(obsx, dtype)
            else:
                self.periods = jnp.asarray(obsx, dtype)
                self.interp_x = None
        elif self.kind == 'rf':
            self.wave_type = RF_REFS[target.ref]
            self.fsamp = float(plugin.fsamp)
            self.tshift = float(plugin.tshft)
            self.nsamp = int(plugin.nsamp)
            self.gauss_a = float(plugin.modelparams['gauss'])
            self.p = float(plugin.modelparams['p'])
            self.nsv = plugin.modelparams.get('nsv', None)
        else:
            # custom target: the plugin must expose a JAX-traceable
            # forward `run_model_jax(h, vp, vs, rho) -> y` over padded
            # (NL,) layer arrays (see templates/myfwd.py)
            fwd = getattr(plugin, 'run_model_jax', None)
            if fwd is None:
                raise NotImplementedError(
                    'custom target %r: its forward plugin must define '
                    'run_model_jax(h, vp, vs, rho) -> y (a JAX-'
                    'traceable, fixed-shape function; see '
                    'templates/myfwd.py)' % target.ref)
            self.jax_forward = fwd

        if self.cov == 'gauss':
            self.dof_correction = bool(dof_correction)
            whitener, logdet = lk.gauss_whitener(
                corr_value, self.ndata, rcond=rcond,
                return_kept=self.dof_correction)
            self.whitener = jnp.asarray(whitener, dtype)
            self.logcorr_det = float(logdet)
        elif self.cov == 'nocorr_scalederr':
            yerr = np.asarray(target.obsdata.yerr, float)
            scaled = yerr / yerr.min()
            self.scaled_err = jnp.asarray(scaled, dtype)
            self.log_scalederr_sum = float(np.sum(np.log(scaled)))

    def yobs_for(self, cell):
        return self.yobs[cell] if self.batched_obs else self.yobs


def build_evaluator(joint, priors, initparams, nl, dtype=jnp.float32):
    """Return the :class:`EvalBundle` of one chain model.

    ``joint`` is a host JointTarget; ``nl`` the fixed model width
    (maxlayers+1).  The returned functions are pure and vmappable.
    """
    rcond = initparams.get('rcond', None)
    # sigma-unbiased Gaussian law on the rcond-truncated subspace
    # (see likelihood.loglike_gauss_white_dof); off by default for
    # logL parity with the reference
    dof_corr = bool(initparams.get('gauss_dof_correction', False))
    mantle = priors.get('mantle', None)
    if mantle is not None:
        mantle = tuple(float(v) for v in mantle)

    # per-target corr prior (fixed vs inverted) — mirrors
    # draw_initnoiseparams (src/SingleChain.py:125-150)
    specs = []
    for target in joint.targets:
        corr_prior = priors[target.noiseref + 'noise_corr']
        corr_fixed = isinstance(corr_prior, (int, float))
        corr_value = float(corr_prior) if corr_fixed else None
        specs.append(_TargetSpec(target, corr_fixed, corr_value, rcond,
                                 dtype, dof_correction=dof_corr))

    ntargets = len(specs)

    def _loglike(spec, ydiff_safe, corr, sigma):
        if spec.cov == 'exp':
            return lk.loglike_exp(ydiff_safe, sigma, corr)
        if spec.cov == 'nocorr':
            return lk.loglike_nocorr(ydiff_safe, sigma)
        if spec.cov == 'nocorr_scalederr':
            return lk.loglike_nocorr_scalederr(
                ydiff_safe, sigma, spec.scaled_err,
                spec.log_scalederr_sum)
        if getattr(spec, 'dof_correction', False):
            return lk.loglike_gauss_white_dof(ydiff_safe, sigma,
                                              spec.whitener,
                                              spec.logcorr_det)
        return lk.loglike_gauss_white(ydiff_safe, sigma,
                                      spec.whitener, spec.logcorr_det)

    def _forward(spec, h, vp, vs_l, rho, c_prev, ring_width):
        """One target's synthetic data; returns (y, tvalid, roots)."""
        if spec.kind == 'custom':
            y = spec.jax_forward(h, vp, vs_l, rho)
            return y, jnp.all(jnp.isfinite(y)), jnp.zeros((0,), dtype)
        if spec.kind == 'swd':
            cg, err, roots = surfdisp_roots(
                h, vp, vs_l, rho, spec.periods, c_prev=c_prev,
                iwave=spec.iwave, igr=spec.igr, mode=spec.mode,
                iflsph=spec.flsph, warm_halfwidth=ring_width)
            if spec.interp_x is not None:
                y = jnp.interp(spec.interp_x, spec.periods, cg)
            else:
                y = cg
            return y, jnp.logical_not(err), roots
        # rf
        qp = jnp.full((nl,), 500.0, dtype)
        qs = jnp.full((nl,), 225.0, dtype)
        vpvs0 = vp[0] / vs_l[0]
        poisson = (2.0 - vpvs0 ** 2) / (2.0 - 2.0 * vpvs0 ** 2)
        nsv = vs_l[0] if spec.nsv is None else spec.nsv
        _, _, rf_t = synrf(h, vp, vs_l, rho, qp, qs,
                           spec.p, spec.gauss_a, spec.nsamp,
                           spec.fsamp, spec.tshift, nsv,
                           poisson, wave_type=spec.wave_type)
        y = rf_t[:spec.ndata]
        return y, jnp.all(jnp.isfinite(y)), jnp.zeros((0,), dtype)

    def _eval(vs, z, n, vpvs, noise, cache, cell, ring_width=16):
        h, vp, vs_l, rho = voronoi_to_layers(vs, z, n, vpvs,
                                             mantle=mantle)
        logL = jnp.zeros((), dtype)
        misfits = []
        valid = jnp.asarray(True)
        new_cache = []

        for i, spec in enumerate(specs):
            c_prev = cache[i][1] if cache is not None \
                and spec.kind == 'swd' else None
            y, tvalid, roots = _forward(spec, h, vp, vs_l, rho, c_prev,
                                        ring_width)
            new_cache.append((y, roots))

            ydiff = jnp.where(tvalid, y - spec.yobs_for(cell), 0.0)
            misfits.append(jnp.sqrt(jnp.mean(ydiff ** 2)))
            logL = logL + _loglike(spec, ydiff, noise[2 * i],
                                   noise[2 * i + 1])
            valid = valid & tvalid

        valid = valid & jnp.isfinite(logL)
        misfits = jnp.stack(misfits + [sum(misfits)])
        logL = jnp.where(valid, logL, LOGL_SENTINEL)
        misfits = jnp.where(valid, misfits, MISFIT_SENTINEL)
        return logL, misfits.astype(dtype), valid, tuple(new_cache)

    def eval_full(vs, z, n, vpvs, noise, cache, cell=0,
                  ring_width=16):
        """``ring_width`` (static) sets the warm-search ring size; the
        sampler passes one per move type (sampler/chain.py
        _ring_width_for)."""
        return _eval(vs, z, n, vpvs, noise, cache, cell, ring_width)

    def eval_cold(vs, z, n, vpvs, noise, cell=0):
        return _eval(vs, z, n, vpvs, noise, None, cell)

    def eval_noise(noise, cache, cell=0):
        """Likelihood under new noise hyperparameters with the cached
        synthetic data (the model is unchanged by a noise move, so the
        forward solves and misfits are reusable)."""
        logL = jnp.zeros((), dtype)
        valid = jnp.asarray(True)
        for i, spec in enumerate(specs):
            y = cache[i][0]
            tvalid = jnp.all(jnp.isfinite(y))
            ydiff = jnp.where(tvalid, y - spec.yobs_for(cell), 0.0)
            logL = logL + _loglike(spec, ydiff, noise[2 * i],
                                   noise[2 * i + 1])
            valid = valid & tvalid
        valid = valid & jnp.isfinite(logL)
        logL = jnp.where(valid, logL, LOGL_SENTINEL)
        return logL, valid

    return EvalBundle(eval_full, eval_cold, eval_noise, ntargets,
                      specs)
