"""Randomized receiver-function stress sweep against the independent
native C++ reflectivity golden (native/reflectivity.cc).

The reference's RF solver (rfmini, reference:
src/extensions/rfmini/greens.cpp:400-683) is numerically delicate in
the evanescent regime (post-critical slowness), for strong
impedance contrasts (LVZ/HVZ), thin layers, and wide/narrow Gauss
filters.  The JAX synthesis and the independent native transcription
must agree to ~1e-6 across randomized models spanning those regimes —
a sign error or branch-cut mistake in either implementation shows up
as a gross waveform mismatch.

Complements tests/test_rf.py (golden-pinned tutorial case, physics
properties) and tests/test_swd_sweep.py (the dispersion analogue).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bayhunter_jax.ops.rf import synrf, P_WAVE, SV_WAVE

from bayhunter_jax import native


@pytest.fixture(autouse=True)
def _native_library():
    if native.load() is None:  # pragma: no cover
        pytest.skip('native library unavailable')

NL = 10
NSAMP = 256
FSAMP = 5.0
TSHIFT = 5.0
KINDS = ('plain', 'lvz', 'hvz', 'thin', 'sediment')
N_PER_KIND = 8


def _pad(arr, hs):
    out = np.full(NL, hs)
    out[:arr.size] = arr
    return out


def make_model(rs, kind):
    """Random crustal model of a pathology class (see module doc)."""
    nlay = rs.randint(3, 7)
    vs = np.sort(rs.uniform(2.2, 4.6, nlay))
    h = rs.uniform(3.0, 15.0, nlay)
    if kind == 'lvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = vs[i - 1] * rs.uniform(0.7, 0.95)
    elif kind == 'hvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = min(vs[i + 1] * rs.uniform(1.05, 1.3), 4.8)
    elif kind == 'thin':
        h[rs.randint(0, nlay - 1)] = rs.uniform(0.3, 1.5)
    elif kind == 'sediment':
        # slow shallow layer: strong reverberations, tests the
        # waterlevel deconvolution and post-critical P leg
        vs[0] = rs.uniform(1.2, 2.0)
        h[0] = rs.uniform(0.5, 3.0)
    h[-1] = 0.0
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    return h, vp, vs, rho


@pytest.fixture(scope='module')
def jax_rf():
    """One compiled f64 synthesis per wave type; slowness and Gauss
    width are traced so the sweep reuses the compilation."""
    fns = {}
    for w in (P_WAVE, SV_WAVE):
        fns[w] = jax.jit(
            lambda h, vp, vs, rho, qp, qs, p, g, nsv, w=w:
            synrf(h, vp, vs, rho, qp, qs, p, g, NSAMP, FSAMP,
                  TSHIFT, nsv, 0.25, wave_type=w)[2])
    return fns


def test_rf_sweep_native_parity(jax_rf):
    """80 randomized models x 2 wave types x randomized slowness and
    Gauss width: JAX vs native waveform maxdiff < 2e-6 (the two
    implementations share no code — one is complex 2x2 component
    algebra in JAX, the other direct C++)."""
    rs = np.random.RandomState(1234)
    worst = 0.0
    ncases = 0
    for kind in KINDS:
        for i in range(N_PER_KIND):
            h, vp, vs, rho = make_model(rs, kind)
            nlay = len(h)
            qp = np.full(nlay, 500.0)
            qs = np.full(nlay, 225.0)
            for wave in (P_WAVE, SV_WAVE):
                p = rs.uniform(4.5, 8.0)   # s/deg, pre/post-critical
                g = rs.uniform(0.6, 3.0)   # Gauss width
                rf_n = native.synrf_native(
                    h, vp, vs, rho, qp, qs, p, g, NSAMP, FSAMP,
                    TSHIFT, vs[0], 0.25, wave_type=wave)[2]
                rf_j = jax_rf[wave](
                    jnp.asarray(_pad(h, 0.0)),
                    jnp.asarray(_pad(vp, vp[-1])),
                    jnp.asarray(_pad(vs, vs[-1])),
                    jnp.asarray(_pad(rho, rho[-1])),
                    jnp.asarray(np.full(NL, 500.0)),
                    jnp.asarray(np.full(NL, 225.0)),
                    jnp.asarray(p), jnp.asarray(g),
                    jnp.asarray(vs[0]))
                d = float(np.max(np.abs(np.asarray(rf_j) - rf_n)))
                worst = max(worst, d)
                ncases += 1
                assert d < 2e-6, \
                    '%s[%d] wave=%d p=%.2f g=%.2f maxdiff %.2e' \
                    % (kind, i, wave, p, g, d)
    assert ncases == len(KINDS) * N_PER_KIND * 2
    assert np.isfinite(worst)


def test_rf_sweep_amplitude_sanity(jax_rf):
    """RFs stay bounded and the direct arrival dominates for simple
    models — a cheap absolute check that does not depend on the
    golden (guards against a common-mode bug in both solvers)."""
    rs = np.random.RandomState(7)
    for _ in range(10):
        h, vp, vs, rho = make_model(rs, 'plain')
        rf = np.asarray(jax_rf[P_WAVE](
            jnp.asarray(_pad(h, 0.0)),
            jnp.asarray(_pad(vp, vp[-1])),
            jnp.asarray(_pad(vs, vs[-1])),
            jnp.asarray(_pad(rho, rho[-1])),
            jnp.asarray(np.full(NL, 500.0)),
            jnp.asarray(np.full(NL, 225.0)),
            jnp.asarray(6.4), jnp.asarray(1.0),
            jnp.asarray(vs[0])))
        assert np.all(np.isfinite(rf))
        # bounded energy; converted phases carry the signal (the
        # direct arrival itself is annihilated by the exact surface
        # rotation — pinned by test_rf.py::
        # test_rf_direct_arrival_near_zero)
        assert 1e-3 < np.max(np.abs(rf)) < 2.0
