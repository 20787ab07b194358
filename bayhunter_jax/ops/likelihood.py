"""Correlated-noise Gaussian log-likelihood kernels (pure JAX).

Accelerator equivalents of the reference's ``Valuation`` covariance
machinery (reference: src/Targets.py:85-183).  Key design change: the
exponential-correlation case never materializes the tridiagonal inverse
matrix — the Mahalanobis quadratic form is evaluated with three O(n)
contractions.  The Gaussian-correlation case precomputes the dense
inverse once on the host (matching the reference's once-per-chain
amortization, src/Targets.py:150-160) and evaluates the quadratic form
as a batched matmul when vmapped over chains.

Every matrix product states ``precision=HIGHEST``: a GPU may otherwise
run float32 products in TF32 (about three decimal digits), and the
r≈1 Gaussian kernels have condition numbers above 1e12.

All functions return the log-likelihood
``logL = -0.5 (n log 2π + log|C|) - madist/2``
(reference: src/Targets.py:176-183).
"""

import jax.numpy as jnp
import numpy as np
from jax import lax

LOG2PI = float(np.log(2.0 * np.pi))
HIGHEST = lax.Precision.HIGHEST


def rms(yobs, ymod):
    """Root-mean-square misfit (reference: src/Targets.py:100-103)."""
    return jnp.sqrt(jnp.mean((ymod - yobs) ** 2, axis=-1))


def _assemble(n, logc_det, madist):
    return -0.5 * (n * LOG2PI + logc_det) - 0.5 * madist


def loglike_nocorr(ydiff, sigma):
    """Uncorrelated noise, identity correlation
    (reference: src/Targets.py:106-115)."""
    n = ydiff.shape[-1]
    madist = jnp.sum(ydiff * ydiff, axis=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * jnp.log(sigma)
    return _assemble(n, logc_det, madist)


def loglike_nocorr_scalederr(ydiff, sigma, scaled_err, log_scalederr_sum):
    """Uncorrelated noise with relatively-scaled data errors
    (reference: src/Targets.py:118-129).  ``scaled_err = yerr/min(yerr)``
    and ``log_scalederr_sum = sum(log(scaled_err))`` are host-side
    constants of the observed data.
    """
    n = ydiff.shape[-1]
    madist = jnp.sum(ydiff * ydiff / scaled_err, axis=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * jnp.log(sigma) + log_scalederr_sum
    return _assemble(n, logc_det, madist)


def loglike_exp(ydiff, sigma, corr):
    """Exponential correlation law r^|i-j|: analytic tridiagonal inverse
    evaluated matrix-free (reference: src/Targets.py:132-148).

    C^-1 = tridiag(diag = [1, 1+r², ..., 1+r², 1], off = -r) / (σ²(1-r²))
    log|C| = 2n log σ + (n-1) log(1-r²)
    """
    n = ydiff.shape[-1]
    d2 = ydiff * ydiff
    s_all = jnp.sum(d2, axis=-1)
    s_int = jnp.sum(d2[..., 1:-1], axis=-1)
    s_cross = jnp.sum(ydiff[..., :-1] * ydiff[..., 1:], axis=-1)
    quad = s_all + corr * corr * s_int - 2.0 * corr * s_cross
    madist = quad / (sigma * sigma * (1.0 - corr * corr))
    logc_det = (2.0 * n) * jnp.log(sigma) \
        + (n - 1) * jnp.log(1.0 - corr * corr)
    return _assemble(n, logc_det, madist)


def loglike_gauss_white(ydiff, sigma, whitener, logcorr_det):
    """Gaussian correlation law evaluated through the WHITENED factor
    ``W`` (n, k) with ``C^-1 ≈ W W^T`` (see :func:`gauss_whitener`).

    The quadratic form ``||W^T ydiff||²`` is a sum of squares, so it
    stays non-negative in float32 — the dense-inverse contraction of
    :func:`loglike_gauss` can round NEGATIVE for near-fitting
    residuals under the extreme conditioning of r≈1 Gaussian kernels
    (condition numbers >1e12), which lets a sampler drive
    ``-madist/2`` to +infinity by shrinking sigma.
    """
    n = ydiff.shape[-1]
    w = jnp.matmul(ydiff, whitener, precision=HIGHEST)   # (..., k)
    madist = jnp.sum(w * w, axis=-1) / (sigma * sigma)
    logc_det = (2.0 * n) * jnp.log(sigma) + logcorr_det
    return _assemble(n, logc_det, madist)


def loglike_gauss_white_dof(ydiff, sigma, whitener, logdet_kept):
    """Degrees-of-freedom-corrected Gaussian law on the truncated
    subspace.  The rcond truncation keeps only k of n eigenvalues, so
    normalizing by n (as :func:`loglike_gauss_white` and the reference
    do, src/Targets.py:150-160) biases the sigma posterior low by
    sqrt(k/n) — only k whitened components actually contribute to the
    quadratic form.  This is the EXACT likelihood of the k-dimensional
    projection z = U_k^T ydiff ~ N(0, sigma^2 Λ_k): normalization uses
    k and the log-determinant of the KEPT spectrum, so the sigma MLE
    is unbiased for the injected noise level.  Opt in via
    ``initparams['gauss_dof_correction'] = True``.
    """
    k = whitener.shape[-1]
    w = jnp.matmul(ydiff, whitener, precision=HIGHEST)   # (..., k)
    madist = jnp.sum(w * w, axis=-1) / (sigma * sigma)
    logc_det = (2.0 * k) * jnp.log(sigma) + logdet_kept
    return _assemble(k, logc_det, madist)


def loglike_gauss(ydiff, sigma, corr_inv, logcorr_det):
    """Gaussian correlation law r^((i-j)²) with precomputed correlation
    inverse (reference: src/Targets.py:150-173).  ``corr_inv`` is the
    (n, n) host-precomputed inverse/pinv of the correlation matrix and
    ``logcorr_det`` its log-determinant.  The contraction is a matvec
    (batched: a matmul).
    """
    n = ydiff.shape[-1]
    madist = jnp.einsum('...i,ij,...j->...', ydiff, corr_inv, ydiff,
                        precision=HIGHEST) / (sigma * sigma)
    logc_det = (2.0 * n) * jnp.log(sigma) + logcorr_det
    return _assemble(n, logc_det, madist)


# ----------------------------------------------------------------------
# host-side precomputation (numpy; once per inversion)
# ----------------------------------------------------------------------

def gauss_correlation_matrix(corr, size):
    """R[i,j] = corr**((i-j)**2) (reference: src/Targets.py:150-154)."""
    idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
    return np.asarray(corr) ** (idx ** 2)


def init_covariance_gauss(corr, size, rcond=None):
    """Dense inverse (or pinv with rcond) + slogdet of the Gaussian
    correlation matrix; computed once per inversion on the host
    (reference: src/Targets.py:150-160)."""
    rmatrix = gauss_correlation_matrix(corr, size)
    if rcond is not None:
        corr_inv = np.linalg.pinv(rmatrix, rcond=rcond)
    else:
        corr_inv = np.linalg.inv(rmatrix)
    _, logdet = np.linalg.slogdet(rmatrix)
    return corr_inv, float(logdet)


def gauss_whitener(corr, size, rcond=None, return_kept=False):
    """Whitening factor W (n, k) of the Gaussian correlation matrix:
    ``C^-1 ≈ W W^T`` with W = U diag(1/sqrt(λ)) over the eigenvalues
    kept by the reference's rcond pseudo-inverse truncation
    (reference: src/Targets.py:155-158).  The same subspace as
    ``np.linalg.pinv(R, rcond)``, but the quadratic form becomes a
    sum of squares — non-negative by construction in any precision.
    Returns (W, logdet of the FULL matrix, as the reference uses);
    with ``return_kept=True``, returns (W, Σ log λ_kept) instead —
    the determinant that pairs with :func:`loglike_gauss_white_dof`.
    """
    rmatrix = gauss_correlation_matrix(corr, size)
    lam, u = np.linalg.eigh(rmatrix)
    if rcond is not None:
        keep = lam > rcond * lam.max()
    else:
        keep = lam > 0
    w = u[:, keep] / np.sqrt(lam[keep])
    if return_kept:
        return w, float(np.sum(np.log(lam[keep])))
    _, logdet = np.linalg.slogdet(rmatrix)
    return w, float(logdet)


def exp_correlation_matrix(corr, size):
    """R[i,j] = corr**|i-j| (for synthetic noise generation;
    reference: src/SynthObs.py:136-143)."""
    idx = np.abs(np.subtract.outer(np.arange(size), np.arange(size)))
    return np.asarray(corr) ** idx
