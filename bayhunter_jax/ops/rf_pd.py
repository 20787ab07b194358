"""Linearized RF inversion: exact partial derivatives + truncated-SVD
Gauss-Newton steps.

Accelerator equivalent of the reference's *dormant* partial-derivative
path: rfmini can compute a finite-difference matrix ``drdp`` by
re-running the reflectivity solver once per perturbed layer
(reference: src/extensions/rfmini/greens.cpp:592-680, assembled at
:761-815 as ``drdp[j][k] = (rf_k[j] - rf[j]) / pert``) and solve the
linearized system with Numerical-Recipes ``svdcmp``/``svbksb``
(reference: src/extensions/rfmini/pd.cpp:5-31).  That machinery is
unreachable from the reference's Python API (synrf.cpp:52 passes
``drdp=NULL``); here the same capability is a working feature, done
the vectorized way:

  * the Jacobian is EXACT forward-mode autodiff through the same
    ``synrf`` forward the sampler uses — no perturbation-size tuning
    and no per-layer re-solve loop: ``jax.linearize`` traces the
    forward once and the layer tangents push through the vectorized
    frequency axis as one batched linear program;
  * the perturbation coupling follows ``FlatLayer::perturb``
    (reference: src/extensions/rfmini/model.cpp:169-192): a vs change
    moves vp with the layer's vp/vs ratio held fixed and rho through
    a selectable density law.  (The reference perturbs the
    *flattened* vs; we differentiate w.r.t. the physical vs, which
    differs only by the fixed flattening factor r/R per layer —
    absorbable in the parametrization and irrelevant to the
    least-squares solution.  The reference also always re-derives the
    perturbed rho with the full Berteussen relation even when the
    unperturbed model's rho follows a different law, which puts a
    spurious O(rho_mismatch/pert) term into its finite differences;
    here the coupling is consistent by construction and defaults to
    this framework's sampler convention ``rho = 0.32 vp + 0.77``,
    Targets.py's default, so inversions against sampler-forward data
    are exactly self-consistent.)
  * the solve is a truncated-SVD least squares with ``svbksb``
    semantics — singular values below ``rcond * s_max`` contribute
    nothing — plus optional Levenberg damping; everything jits and
    batches over models with ``jax.vmap``.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from bayhunter_jax.ops.rf import P_WAVE, rho_vp, synrf


def _rho_law(rho_coupling, rho0):
    """Density riding along a vp change: 'bayhunter' = the sampler's
    0.32 vp + 0.77 (reference: src/Targets.py:319), 'berteussen' =
    the full rfmini relation (model.cpp:150-165, what
    FlatLayer::perturb uses), 'fixed' = rho frozen at the input."""
    if rho_coupling == 'bayhunter':
        return lambda vp_p: 0.32 * vp_p + 0.77
    if rho_coupling == 'berteussen':
        return lambda vp_p: rho_vp(vp_p)
    if rho_coupling == 'fixed':
        return lambda vp_p: rho0
    raise ValueError('unknown rho_coupling %r' % (rho_coupling,))


def _parameter_basis(h, dtype):
    """Tangent basis P (NL, NL): row k is the slot direction moved by
    parameter k.  Finite layers map one-to-one; the halfspace
    parameter (row = first zero-thickness slot) moves ALL trailing
    padded slots together, because the padding contract (ops/
    voronoi.py, forward/rf_plugin.py ``_pad``) replicates the
    halfspace value there AND because a lone zero-thickness slot is
    exactly invisible to the response — two welded interfaces with no
    separation compose to the direct contact of the outer media, so
    its solo Jacobian column is identically zero; the physical
    halfspace derivative only appears when every copy (including the
    last slot, which carries the direct-wave t0 term,
    greens.cpp:509-526) moves at once.  Rows for the remaining padded
    slots are zero: they are not parameters."""
    nl = h.shape[-1]
    finite = h > 0
    idx = jnp.arange(nl)
    has_pad = jnp.any(~finite)
    k0 = jnp.argmax(~finite)          # first zero-thickness slot
    diag = jnp.diag(finite.astype(dtype))
    hs = ((idx[:, None] == k0) & (idx[None, :] >= k0)
          & has_pad).astype(dtype)
    return diag + hs


@partial(jax.jit, static_argnames=('nsamp', 'wave_type', 'flattening',
                                   'first', 'nused', 'rho_coupling'))
def rf_partials(h, vp, vs, qp, qs, p_sdeg, gauss_a, nsamp, fsamp,
                tshift, nsv, poisson, wave_type=P_WAVE, first=0,
                nused=None, flattening=True, rho_coupling='bayhunter',
                rho=None):
    """Receiver function and its exact vs-Jacobian for one padded model.

    Arguments mirror :func:`bayhunter_jax.ops.rf.synrf`; ``first`` /
    ``nused`` select the sample window entering the inversion (the
    ``first``/``nused`` arguments of the reference's ``calcresp``,
    greens.cpp:701-702).

    Returns ``(rf_win, J)`` with ``rf_win`` of shape (nused,) and
    ``J[i, k] = d rf[first + i] / d vs-parameter k`` of shape
    (nused, NL), where a change of parameter ``k`` carries vp (fixed
    vp/vs) and rho (the ``rho_coupling`` law) along, as in
    ``FlatLayer::perturb``.  Parameter k < n-1 is layer k's vs; the
    parameter at the first zero-thickness slot is the halfspace vs
    (moving every trailing padded copy together — see
    ``_parameter_basis``); columns for the remaining padded slots are
    zero.
    """
    if nused is None:
        nused = nsamp - first
    ratio = vp / jnp.where(vs > 0, vs, 1.0)
    rho_of = _rho_law(rho_coupling, rho)

    def fwd(vs_p):
        vp_p = ratio * vs_p
        rho_p = rho_of(vp_p)
        _, _, rf = synrf(h, vp_p, vs_p, rho_p, qp, qs, p_sdeg, gauss_a,
                         nsamp, fsamp, tshift, nsv, poisson,
                         wave_type=wave_type, flattening=flattening)
        return lax.slice(rf, (first,), (first + nused,))

    rf_win, jvp = jax.linearize(fwd, vs)
    basis = _parameter_basis(h, vs.dtype)
    J = jax.vmap(jvp)(basis)                    # (NL, nused)
    return rf_win, J.T


def truncated_svd_solve(J, resid, rcond=1e-4, damping=0.0):
    """Least-squares step ``dx`` minimizing ``|J dx - resid|``.

    ``svbksb`` semantics (reference: pd.cpp:5-31): singular components
    with ``s <= rcond * s_max`` are dropped.  ``damping`` (relative to
    ``s_max``) adds Levenberg regularization ``s/(s^2 + (d*s_max)^2)``
    on the kept components, which the dormant reference solver leaves
    to the caller's TOL choice.
    """
    U, s, Vt = jnp.linalg.svd(J, full_matrices=False)
    smax = jnp.max(s)
    keep = s > rcond * smax
    d2 = (damping * smax) ** 2
    inv_s = jnp.where(keep, s / (s * s + d2), 0.0)
    hi = lax.Precision.HIGHEST   # no TF32 in the float32 solve
    return jnp.matmul(Vt.T, inv_s * jnp.matmul(U.T, resid, precision=hi),
                      precision=hi)


@partial(jax.jit, static_argnames=('nsamp', 'wave_type', 'flattening',
                                   'first', 'nused', 'niter',
                                   'rho_coupling'))
def invert_rf(rf_obs, h, vp, vs, qp, qs, p_sdeg, gauss_a, nsamp, fsamp,
              tshift, nsv, poisson, wave_type=P_WAVE, first=0,
              nused=None, flattening=True, niter=6, rcond=1e-4,
              damping=0.05, dvs_max=0.25, vs_min=0.1,
              rho_coupling='bayhunter', rho=None):
    """Damped Gauss-Newton refinement of the layer vs profile against
    an observed receiver function.

    Each iteration evaluates :func:`rf_partials` and takes a
    truncated-SVD step, clipped to ``dvs_max`` km/s per layer and
    floored at ``vs_min``; vp and rho follow vs as in
    ``FlatLayer::perturb``.  Returns ``(vs_out, rms_trace)`` with
    ``rms_trace`` of shape (niter,) holding the pre-step residual RMS
    — useful both as a convergence diagnostic and as a linearized
    misfit-landscape probe around an McMC solution.

    Batch over models with ``jax.vmap`` (all arguments except the
    static configuration may carry a leading batch axis).
    """
    if nused is None:
        nused = min(rf_obs.shape[-1], nsamp) - first
    basis = _parameter_basis(h, vs.dtype)
    obs_win = lax.slice(rf_obs, (first,), (first + nused,)) \
        if rf_obs.shape[-1] != nused else rf_obs

    def step(vs_cur, _):
        rf_win, J = rf_partials(
            h, vp * (vs_cur / vs), vs_cur, qp, qs, p_sdeg, gauss_a,
            nsamp, fsamp, tshift, nsv, poisson, wave_type=wave_type,
            first=first, nused=nused, flattening=flattening,
            rho_coupling=rho_coupling, rho=rho)
        resid = obs_win - rf_win
        rms = jnp.sqrt(jnp.mean(resid * resid))
        dp = truncated_svd_solve(J, resid, rcond=rcond,
                                 damping=damping)
        # spread parameter steps back to slots (halfspace parameter
        # moves every trailing padded copy — see _parameter_basis)
        dvs = jnp.matmul(jnp.clip(dp, -dvs_max, dvs_max), basis,
                         precision=lax.Precision.HIGHEST)
        return jnp.maximum(vs_cur + dvs, vs_min), rms

    vs_out, rms_trace = lax.scan(step, vs, None, length=niter)
    return vs_out, rms_trace
