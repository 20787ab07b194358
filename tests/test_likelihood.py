"""Likelihood kernels vs dense reference formulations."""

import numpy as np
import pytest
import jax.numpy as jnp

from bayhunter_jax.ops import likelihood as lk


def dense_logl(ydiff, c_inv, logc_det):
    n = ydiff.size
    madist = ydiff @ c_inv @ ydiff
    return -0.5 * (n * np.log(2 * np.pi) + logc_det) - madist / 2


def test_nocorr_matches_dense():
    rng = np.random.RandomState(0)
    d = rng.randn(37)
    sigma = 0.02
    c_inv = np.eye(37) / sigma ** 2
    logdet = 2 * 37 * np.log(sigma)
    expect = dense_logl(d, c_inv, logdet)
    got = float(lk.loglike_nocorr(jnp.asarray(d), sigma))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_exp_matches_dense_tridiagonal():
    """Matrix-free exponential-correlation logL equals the reference's
    explicit tridiagonal inverse (src/Targets.py:132-148)."""
    rng = np.random.RandomState(1)
    n = 41
    d = rng.randn(n) * 0.01
    sigma, corr = 0.012, 0.55

    diag = np.ones(n) + corr ** 2
    diag[0] = diag[-1] = 1
    off = np.ones(n - 1) * -corr
    c_inv = (np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)) \
        / (sigma ** 2 * (1 - corr ** 2))
    logdet = 2 * n * np.log(sigma) + (n - 1) * np.log(1 - corr ** 2)
    expect = dense_logl(d, c_inv, logdet)
    got = float(lk.loglike_exp(jnp.asarray(d), sigma, corr))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_exp_inverse_is_true_inverse():
    """The analytic tridiagonal form actually inverts the exponential
    correlation matrix."""
    n, corr = 25, 0.7
    R = lk.exp_correlation_matrix(corr, n)
    diag = np.ones(n) + corr ** 2
    diag[0] = diag[-1] = 1
    off = np.ones(n - 1) * -corr
    R_inv = (np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)) \
        / (1 - corr ** 2)
    np.testing.assert_allclose(R @ R_inv, np.eye(n), atol=1e-10)


def test_gauss_matches_dense():
    rng = np.random.RandomState(2)
    n = 51
    d = rng.randn(n) * 0.005
    sigma, corr = 0.005, 0.9
    corr_inv, logcorr_det = lk.init_covariance_gauss(corr, n)
    c_inv = corr_inv / sigma ** 2
    logdet = 2 * n * np.log(sigma) + logcorr_det
    expect = dense_logl(d, c_inv, logdet)
    got = float(lk.loglike_gauss(jnp.asarray(d), sigma,
                                 jnp.asarray(corr_inv), logcorr_det))
    np.testing.assert_allclose(got, expect, rtol=1e-10)


def test_scalederr_matches_dense():
    rng = np.random.RandomState(3)
    n = 19
    d = rng.randn(n)
    yerr = rng.rand(n) + 0.5
    sigma = 0.1
    scaled = yerr / yerr.min()
    c_inv = np.diag(1.0 / (scaled * sigma ** 2))
    logdet = 2 * n * np.log(sigma) + np.log(np.prod(scaled))
    expect = dense_logl(d, c_inv, logdet)
    got = float(lk.loglike_nocorr_scalederr(
        jnp.asarray(d), sigma, jnp.asarray(scaled),
        float(np.sum(np.log(scaled)))))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_batched_shapes():
    d = jnp.asarray(np.random.RandomState(4).randn(16, 21))
    sig = jnp.full((16,), 0.01)
    out = lk.loglike_exp(d, sig, jnp.full((16,), 0.3))
    assert out.shape == (16,)


def test_gauss_whitener_matches_pinv_and_stays_psd():
    """The whitened Gaussian law must (a) agree with the dense pinv
    form in float64 and (b) keep the Mahalanobis term non-negative in
    float32 even for near-fitting residuals under extreme conditioning
    (r=0.98, n=201) — the dense contraction can round negative, which
    lets the sampler blow logL up by shrinking sigma (regression for a
    bug caught in a tutorial-scale accelerator run)."""
    import numpy as np
    import jax.numpy as jnp
    from bayhunter_jax.ops import likelihood as lk

    n, corr, rcond = 201, 0.98, 1e-5
    rs = np.random.RandomState(0)

    w, logdet_w = lk.gauss_whitener(corr, n, rcond=rcond)
    corr_inv, logdet_i = lk.init_covariance_gauss(corr, n, rcond=rcond)
    assert abs(logdet_w - logdet_i) < 1e-6

    # (a) agreement with the dense pinv form in f64
    d = 0.05 * rs.normal(size=n)
    q_w = float(np.sum((d @ w) ** 2))
    q_i = float(d @ corr_inv @ d)
    np.testing.assert_allclose(q_w, q_i, rtol=1e-8)

    # (b) f32 positivity on many small (near-fit) residuals
    w32 = jnp.asarray(w, jnp.float32)
    for trial in range(50):
        d32 = jnp.asarray(1e-3 * rs.normal(size=n), jnp.float32)
        q32 = float(jnp.sum((d32 @ w32) ** 2))
        assert q32 >= 0.0
        logL = float(lk.loglike_gauss_white(d32, jnp.float32(1e-5),
                                            w32, logdet_w))
        # bounded above by the sigma->0 limit of a zero residual
        assert logL < -0.5 * (n * lk.LOG2PI
                              + 2 * n * np.log(1e-5) + logdet_w) + 1.0


def test_gauss_dof_correction_unbiases_sigma():
    """The rcond truncation keeps k of n eigenvalues, so the
    reference-parity law's sigma MLE estimates sqrt(k/n)*sigma_true
    (VALIDATION.md sigma_RF note).  The DOF-corrected law
    (loglike_gauss_white_dof) must recover the injected sigma — and
    the biased law must recover sqrt(k/n)*sigma, confirming the
    correction factor is exactly the subspace fraction."""
    n, corr, rcond = 126, 0.98, 1e-5
    sigma_true = 0.005
    rs = np.random.RandomState(1)

    R = lk.gauss_correlation_matrix(corr, n)
    L = np.linalg.cholesky(R + 1e-12 * np.eye(n))
    draws = 64
    noise = (sigma_true * (L @ rs.normal(size=(n, draws)))).T

    w_full, logdet_full = lk.gauss_whitener(corr, n, rcond=rcond)
    w_kept, logdet_kept = lk.gauss_whitener(corr, n, rcond=rcond,
                                            return_kept=True)
    np.testing.assert_allclose(w_full, w_kept)
    k = w_kept.shape[1]
    assert k < n  # truncation is real at this conditioning

    sig_grid = np.linspace(0.4 * sigma_true, 1.6 * sigma_true, 481)

    def mle(loglike, *args):
        ll = np.array([
            np.mean(np.asarray(loglike(jnp.asarray(noise), s, *args)))
            for s in sig_grid])
        return sig_grid[np.argmax(ll)]

    sig_dof = mle(lk.loglike_gauss_white_dof,
                  jnp.asarray(w_kept), logdet_kept)
    sig_ref = mle(lk.loglike_gauss_white,
                  jnp.asarray(w_full), logdet_full)

    assert abs(sig_dof - sigma_true) < 0.05 * sigma_true, sig_dof
    expect_biased = np.sqrt(k / n) * sigma_true
    assert abs(sig_ref - expect_biased) < 0.05 * sigma_true, \
        (sig_ref, expect_biased)


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in ``fn``'s jaxpr."""
    import jax
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == 'dot_general':
                out.append(eqn.params['precision'])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(jaxpr.jaxpr)
    return out


@pytest.mark.parametrize('law', ['gauss_white', 'gauss_white_dof',
                                 'gauss'])
def test_matrix_products_state_highest_precision(law):
    """A GPU may run float32 products in TF32 unless told otherwise;
    every product of the Gaussian laws (condition numbers >1e12 at
    r = 0.98) must carry Precision.HIGHEST in its jaxpr."""
    from jax import lax
    n = 201
    w, logdet = lk.gauss_whitener(0.98, n, rcond=1e-5)
    yd = jnp.zeros((4, n), jnp.float32)
    sg = jnp.full((4,), 0.01, jnp.float32)
    W = jnp.asarray(w, jnp.float32)
    C_inv = jnp.asarray(w @ w.T, jnp.float32)
    fn = {'gauss_white': lambda d, s: lk.loglike_gauss_white(
              d, s, W, logdet),
          'gauss_white_dof': lambda d, s: lk.loglike_gauss_white_dof(
              d, s, W, logdet),
          'gauss': lambda d, s: lk.loglike_gauss(d, s, C_inv,
                                                 logdet)}[law]
    precs = _dot_precisions(fn, yd, sg)
    assert precs, 'no matrix product found'
    for p in precs:
        assert p is not None and all(
            q == lax.Precision.HIGHEST for q in p), precs


@pytest.mark.parametrize('law', ['gauss_white', 'gauss_white_dof',
                                 'exp'])
def test_f32_matches_f64_at_r098(law):
    """float32 laws against float64 numpy at r = 0.98 on correlated
    residuals (the chip_smoke.py likelihood phase at CPU size):
    relative deviation of logL, scaled by |logL| + madist/2, below
    2e-5 (measured on the CPU: 1e-7 to 2e-6)."""
    n, corr, rows = 201, 0.98, 256
    rs = np.random.RandomState(11)
    lam, u = np.linalg.eigh(lk.gauss_correlation_matrix(corr, n))
    sigma = rs.uniform(0.003, 0.02, rows)
    yd = (rs.standard_normal((rows, n)) * np.sqrt(np.clip(lam, 0, None))
          ) @ u.T * sigma[:, None]
    if law == 'exp':
        d2 = yd ** 2
        q = (d2.sum(-1) + corr ** 2 * d2[:, 1:-1].sum(-1)
             - 2 * corr * (yd[:, :-1] * yd[:, 1:]).sum(-1)) \
            / (sigma ** 2 * (1 - corr ** 2))
        ld = 2 * n * np.log(sigma) + (n - 1) * np.log(1 - corr ** 2)
        ref = -0.5 * (n * np.log(2 * np.pi) + ld) - 0.5 * q

        def fn(d, s):
            return lk.loglike_exp(d, s, corr)
    else:
        dof = law == 'gauss_white_dof'
        w, ldet = lk.gauss_whitener(corr, n, rcond=1e-5,
                                    return_kept=dof)
        k = w.shape[1] if dof else n
        q = np.sum((yd @ w) ** 2, axis=-1) / sigma ** 2
        ref = -0.5 * (k * np.log(2 * np.pi) + 2 * k * np.log(sigma)
                      + ldet) - 0.5 * q
        W = jnp.asarray(w, jnp.float32)
        law_fn = lk.loglike_gauss_white_dof if dof \
            else lk.loglike_gauss_white

        def fn(d, s):
            return law_fn(d, s, W, ldet)
    import jax
    got = np.asarray(jax.vmap(fn)(jnp.asarray(yd, jnp.float32),
                                  jnp.asarray(sigma, jnp.float32)),
                     np.float64)
    rel = np.abs(got - ref) / (np.abs(ref) + 0.5 * q)
    assert rel.max() < 2e-5, rel.max()
