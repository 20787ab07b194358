"""Native C++ goldens vs JAX kernels: the transliterated C++ cores
must agree tightly with the JAX implementations on random models (and
both match the committed reference golden data — covered in
test_swd/test_rf; reference-independent conservation-law anchors live
in test_native_physics.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from bayhunter_jax.ops.swd import surfdisp
from bayhunter_jax.ops.rf import synrf, P_WAVE, SV_WAVE

from bayhunter_jax import native


@pytest.fixture(autouse=True)
def _native_library():
    if native.load() is None:  # pragma: no cover
        pytest.skip('native library unavailable')


def random_model(rs, nlay):
    vs = np.sort(rs.uniform(2.2, 4.6, nlay))
    h = rs.uniform(3.0, 15.0, nlay)
    h[-1] = 0.0
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    return h, vp, vs, rho


def pad(arr, nl, hs):
    out = np.full(nl, hs)
    out[:arr.size] = arr
    return out


@pytest.mark.parametrize('iwave,igr', [(2, 0), (1, 0), (2, 1), (1, 1)])
def test_dispersion_native_vs_jax(iwave, igr):
    rs = np.random.RandomState(7)
    periods = np.linspace(2.0, 35.0, 11)
    NL = 8
    for trial in range(5):
        nlay = rs.randint(2, 6)
        h, vp, vs, rho = random_model(rs, nlay)
        cg_n, err_n = native.surfdisp_native(h, vp, vs, rho, periods,
                                             iwave=iwave, igr=igr)
        hp = pad(h, NL, 0.0)
        cg_j, err_j = surfdisp(jnp.asarray(hp),
                               jnp.asarray(pad(vp, NL, vp[-1])),
                               jnp.asarray(pad(vs, NL, vs[-1])),
                               jnp.asarray(pad(rho, NL, rho[-1])),
                               jnp.asarray(periods),
                               iwave=iwave, igr=igr)
        assert bool(err_j) == err_n
        if not err_n:
            np.testing.assert_allclose(np.asarray(cg_j), cg_n,
                                       atol=5e-5, rtol=1e-5)


def test_dispersion_native_spherical():
    rs = np.random.RandomState(3)
    periods = np.linspace(5.0, 60.0, 8)
    h, vp, vs, rho = random_model(rs, 4)
    cg_n, err_n = native.surfdisp_native(h, vp, vs, rho, periods,
                                         iflsph=1)
    NL = 8
    cg_j, err_j = surfdisp(jnp.asarray(pad(h, NL, 0.0)),
                           jnp.asarray(pad(vp, NL, vp[-1])),
                           jnp.asarray(pad(vs, NL, vs[-1])),
                           jnp.asarray(pad(rho, NL, rho[-1])),
                           jnp.asarray(periods), iflsph=1)
    assert not err_n and not bool(err_j)
    np.testing.assert_allclose(np.asarray(cg_j), cg_n, atol=5e-5)


@pytest.mark.parametrize('wave', [P_WAVE, SV_WAVE])
def test_rf_native_vs_jax(wave):
    rs = np.random.RandomState(11)
    NL = 8
    for trial in range(3):
        nlay = rs.randint(2, 6)
        h, vp, vs, rho = random_model(rs, nlay)
        qp = np.full(nlay, 500.0)
        qs = np.full(nlay, 225.0)
        fz_n, fr_n, rf_n = native.synrf_native(
            h, vp, vs, rho, qp, qs, 6.4, 1.0, 256, 5.0, 5.0,
            vs[0], 0.25, wave_type=wave)
        rf_j = synrf(jnp.asarray(pad(h, NL, 0.0)),
                     jnp.asarray(pad(vp, NL, vp[-1])),
                     jnp.asarray(pad(vs, NL, vs[-1])),
                     jnp.asarray(pad(rho, NL, rho[-1])),
                     jnp.asarray(np.full(NL, 500.0)),
                     jnp.asarray(np.full(NL, 225.0)),
                     6.4, 1.0, 256, 5.0, 5.0, vs[0], 0.25,
                     wave_type=wave)[2]
        np.testing.assert_allclose(np.asarray(rf_j), rf_n, atol=1e-6)


def test_native_higher_mode():
    """First higher mode from the counting search."""
    h = np.array([10.0, 0.0])
    vs = np.array([3.0, 4.5])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    # short periods: the first higher mode has a low-frequency cutoff
    periods = np.linspace(0.5, 3.0, 6)
    cg1, e1 = native.surfdisp_native(h, vp, vs, rho, periods,
                                     iwave=2, mode=1)
    cg2, e2 = native.surfdisp_native(h, vp, vs, rho, periods,
                                     iwave=2, mode=2)
    assert not e1 and not e2
    assert np.all(cg2 > cg1)  # higher modes are faster
    NL = 4
    cg2_j, e2_j = surfdisp(jnp.asarray(pad(h, NL, 0.0)),
                           jnp.asarray(pad(vp, NL, vp[-1])),
                           jnp.asarray(pad(vs, NL, vs[-1])),
                           jnp.asarray(pad(rho, NL, rho[-1])),
                           jnp.asarray(periods), iwave=2, mode=2)
    assert not bool(e2_j)
    np.testing.assert_allclose(np.asarray(cg2_j), cg2, atol=5e-5)


def test_native_love_higher_mode():
    """Love first-higher-mode parity vs the f64 golden (the reference
    mode loop surfdisp96.f:223-229 is wave-type-agnostic; the repo's
    golden coverage previously pinned Rayleigh mode 2 only)."""
    h = np.array([10.0, 0.0])
    vs = np.array([3.0, 4.5])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    periods = np.linspace(0.8, 4.0, 6)
    cg1, e1 = native.surfdisp_native(h, vp, vs, rho, periods,
                                     iwave=1, mode=1)
    cg2, e2 = native.surfdisp_native(h, vp, vs, rho, periods,
                                     iwave=1, mode=2)
    assert not e1 and not e2
    assert np.all(cg2 > cg1)
    NL = 4
    cg2_j, e2_j = surfdisp(jnp.asarray(pad(h, NL, 0.0)),
                           jnp.asarray(pad(vp, NL, vp[-1])),
                           jnp.asarray(pad(vs, NL, vs[-1])),
                           jnp.asarray(pad(rho, NL, rho[-1])),
                           jnp.asarray(periods), iwave=1, mode=2)
    assert not bool(e2_j)
    np.testing.assert_allclose(np.asarray(cg2_j), cg2, atol=5e-5)


@pytest.mark.parametrize('iwave', [1, 2])
def test_native_spherical_group(iwave):
    """Spherical-earth GROUP velocities vs the f64 golden: the
    flattening (surfdisp96.f:486-553) composes with the two
    1%-apart phase solves of igr=1, which amplifies any flattening
    mismatch ~100x — previously only spherical PHASE was pinned."""
    rs = np.random.RandomState(19)
    periods = np.linspace(8.0, 60.0, 7)
    h, vp, vs, rho = random_model(rs, 4)
    cg_n, err_n = native.surfdisp_native(h, vp, vs, rho, periods,
                                         iwave=iwave, igr=1, iflsph=1)
    NL = 8
    cg_j, err_j = surfdisp(jnp.asarray(pad(h, NL, 0.0)),
                           jnp.asarray(pad(vp, NL, vp[-1])),
                           jnp.asarray(pad(vs, NL, vs[-1])),
                           jnp.asarray(pad(rho, NL, rho[-1])),
                           jnp.asarray(periods), iwave=iwave, igr=1,
                           iflsph=1)
    assert not err_n and not bool(err_j)
    # group differencing amplifies the root-refinement resolution
    np.testing.assert_allclose(np.asarray(cg_j), cg_n, atol=2e-4)
