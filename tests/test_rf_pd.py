"""Tests for the linearized RF inversion (ops/rf_pd.py): exact
autodiff Jacobian vs finite differences, truncated-SVD solve, and
Gauss-Newton recovery of a perturbed vs profile."""

import numpy as np
import jax.numpy as jnp

from bayhunter_jax.ops.rf import synrf, P_WAVE
from bayhunter_jax.ops.rf_pd import (rf_partials, truncated_svd_solve,
                                     invert_rf, _parameter_basis)

NL = 8
NSAMP, FSAMP, TSHFT = 256, 5.0, 5.0
NUSED = 128
VPVS = 1.73
POISSON = (2 - VPVS ** 2) / (2 - 2 * VPVS ** 2)


def padded_model(vs_active=(2.7, 3.6, 3.8, 4.4)):
    h_active = [5., 23., 8., 0.][:len(vs_active)]
    h = np.zeros(NL)
    h[:len(h_active)] = h_active
    vs = np.full(NL, vs_active[-1])
    vs[:len(vs_active)] = vs_active
    vp = vs * VPVS
    rho = 0.32 * vp + 0.77   # the sampler's law (default coupling)
    return tuple(jnp.asarray(v) for v in (h, vp, vs, rho))


def rf_args():
    qp = jnp.full(NL, 500.)
    qs = jnp.full(NL, 225.)
    return dict(qp=qp, qs=qs, p_sdeg=6.4, gauss_a=1.0, nsamp=NSAMP,
                fsamp=FSAMP, tshift=TSHFT, nsv=2.7, poisson=POISSON,
                wave_type=P_WAVE)


def forward_rf(h, vs):
    """The coupled forward map: vs with vp/vs and rho riding along."""
    vp = vs * VPVS
    rho = 0.32 * vp + 0.77
    kw = rf_args()
    _, _, rf = synrf(h, vp, vs, rho, kw['qp'], kw['qs'], kw['p_sdeg'],
                     kw['gauss_a'], NSAMP, FSAMP, TSHFT, kw['nsv'],
                     kw['poisson'], wave_type=P_WAVE)
    return np.asarray(rf)[:NUSED]


def test_parameter_basis():
    h, _, vs, _ = padded_model()
    P = np.asarray(_parameter_basis(h, jnp.float64))
    # finite layers one-to-one; halfspace row spreads over all
    # trailing padded copies; pure-pad rows are dead
    expect = np.zeros((NL, NL))
    expect[0, 0] = expect[1, 1] = expect[2, 2] = 1.0
    expect[3, 3:] = 1.0
    np.testing.assert_array_equal(P, expect)
    # single-halfspace edge case: one parameter moving every slot
    P0 = np.asarray(_parameter_basis(jnp.zeros(4), jnp.float64))
    expect0 = np.zeros((4, 4))
    expect0[0] = 1.0
    np.testing.assert_array_equal(P0, expect0)


def test_jacobian_matches_finite_differences():
    """The autodiff Jacobian must match a central finite difference of
    the *coupled* forward (vs moves vp and rho as FlatLayer::perturb
    does) — this pins the coupling, not just the derivative."""
    h, vp, vs, _ = padded_model()
    rf_win, J = rf_partials(h, vp, vs, first=0, nused=NUSED, **rf_args())
    np.testing.assert_allclose(np.asarray(rf_win), forward_rf(h, vs),
                               atol=1e-12)

    eps = 1e-6
    for k in range(4):
        e = np.zeros(NL)
        if k == 3:
            e[3:] = eps   # halfspace parameter: every padded copy
        else:
            e[k] = eps
        fd = (forward_rf(h, vs + e) - forward_rf(h, vs - e)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(J)[:, k], fd,
                                   rtol=2e-4, atol=1e-7)
    # the halfspace column is real signal, not a zero-by-transparency
    assert np.linalg.norm(np.asarray(J)[:, 3]) > 1e-3
    # padded slots: exactly zero columns
    assert float(np.abs(np.asarray(J)[:, 4:]).max()) == 0.0


def test_sample_window():
    h, vp, vs, _ = padded_model()
    full, Jf = rf_partials(h, vp, vs, first=0, nused=NUSED, **rf_args())
    win, Jw = rf_partials(h, vp, vs, first=10, nused=30, **rf_args())
    np.testing.assert_allclose(np.asarray(win), np.asarray(full)[10:40])
    np.testing.assert_allclose(np.asarray(Jw), np.asarray(Jf)[10:40])


def test_rho_couplings_are_wired():
    """The three density laws must actually change the Jacobian (and
    'fixed' must use the caller's rho for the primal)."""
    h, vp, vs, rho = padded_model()
    kw = dict(first=0, nused=NUSED, **rf_args())
    rf_b, J_b = rf_partials(h, vp, vs, rho_coupling='bayhunter', **kw)
    rf_g, J_g = rf_partials(h, vp, vs, rho_coupling='berteussen', **kw)
    rf_f, J_f = rf_partials(h, vp, vs, rho_coupling='fixed', rho=rho,
                            **kw)
    # bayhunter rho == input rho here, so primals agree for b and f
    np.testing.assert_allclose(np.asarray(rf_f), np.asarray(rf_b),
                               atol=1e-12)
    # berteussen adds sediment/transition terms -> different primal
    assert np.abs(np.asarray(rf_g) - np.asarray(rf_b)).max() > 1e-6
    # and the couplings show up in the derivative
    assert np.abs(np.asarray(J_f) - np.asarray(J_b)).max() > 1e-6
    assert np.all(np.isfinite(np.asarray(J_g)))


def test_truncated_svd_solve():
    rng = np.random.RandomState(7)
    # rank-3 J with two zero columns (padded layers)
    J = rng.randn(40, 3) @ rng.randn(3, 3)
    J = np.concatenate([J, np.zeros((40, 2))], axis=1)
    x_true = np.array([0.1, -0.2, 0.05, 0.0, 0.0])
    b = J @ x_true
    x = np.asarray(truncated_svd_solve(jnp.asarray(J), jnp.asarray(b),
                                       rcond=1e-10, damping=0.0))
    np.testing.assert_allclose(J @ x, b, atol=1e-10)
    assert np.abs(x[3:]).max() < 1e-12  # no update along null columns
    # heavy truncation keeps only the largest component but stays finite
    x_t = np.asarray(truncated_svd_solve(jnp.asarray(J), jnp.asarray(b),
                                         rcond=0.999))
    assert np.all(np.isfinite(x_t))


def test_gauss_newton_recovers_vs_profile():
    """Perturb the tutorial vs profile by a few percent and recover it
    from the noiseless synthetic RF (the pd.cpp use case, exercised
    end-to-end with the exact Jacobian)."""
    h, vp, vs, _ = padded_model()
    rf_obs = jnp.asarray(forward_rf(h, vs))

    rng = np.random.RandomState(3)
    dvs = np.zeros(NL)
    dvs[:4] = rng.uniform(-0.08, 0.08, 4)
    dvs[3] = 0.06      # a halfspace error big enough to matter
    dvs[4:] = dvs[3]   # padding contract: copies follow the halfspace
    vs0 = vs + jnp.asarray(dvs)
    vp0 = vs0 * VPVS

    vs_fit, rms = invert_rf(rf_obs, h, vp0, vs0, first=0, nused=NUSED,
                            niter=6, rcond=1e-6, damping=0.01,
                            **rf_args())
    rms = np.asarray(rms)
    assert rms[-1] < rms[0] * 1e-2, rms
    err = np.abs(np.asarray(vs_fit) - np.asarray(vs))[:4]
    assert err.max() < 2e-3, (err, rms)
    # padded copies moved with the halfspace parameter
    np.testing.assert_allclose(np.asarray(vs_fit)[4:],
                               np.asarray(vs_fit)[3], atol=1e-12)
