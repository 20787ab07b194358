"""Golden and property tests for the SWD dispersion solver."""

import numpy as np
import jax.numpy as jnp
import pytest

from bayhunter_jax.ops.swd import surfdisp, surfdisp_batch
from tests.conftest import golden_path

NL = 8


def padded_tutorial(dtype=np.float64):
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    hp = np.zeros(NL)
    hp[:3] = h[:3]

    def pad(x):
        out = np.full(NL, x[-1])
        out[:len(x)] = x
        return out

    return tuple(jnp.asarray(v, dtype) for v in
                 (hp, pad(vp), pad(vs), pad(rho)))


PERIODS = np.linspace(1, 41, 21)
CASES = {'rdispph': (2, 0), 'rdispgr': (2, 1),
         'ldispph': (1, 0), 'ldispgr': (1, 1)}
# golden files carry 4 decimals; group velocities amplify the root
# tolerance by the finite-difference factor ~1/h
TOLS = {'rdispph': 1e-4, 'rdispgr': 5e-4,
        'ldispph': 1e-4, 'ldispgr': 1e-3}


@pytest.mark.parametrize('ref', list(CASES))
def test_golden_dispersion(ref):
    iwave, igr = CASES[ref]
    args = padded_tutorial()
    cg, err = surfdisp(*args, jnp.asarray(PERIODS), iwave=iwave, igr=igr)
    gold = np.loadtxt(golden_path('st3_%s.dat' % ref))[:, 1]
    assert not bool(err)
    np.testing.assert_allclose(np.asarray(cg), gold, atol=TOLS[ref])


@pytest.mark.parametrize('ref', ['rdispph', 'ldispgr'])
def test_golden_dispersion_float32(ref):
    """The production dtype must hit the same golden tolerance."""
    iwave, igr = CASES[ref]
    args = padded_tutorial(np.float32)
    cg, err = surfdisp(*args, jnp.asarray(PERIODS, jnp.float32),
                       iwave=iwave, igr=igr)
    gold = np.loadtxt(golden_path('st3_%s.dat' % ref))[:, 1]
    assert not bool(err)
    np.testing.assert_allclose(np.asarray(cg), gold,
                               atol=3 * TOLS[ref])


def test_batch_matches_single():
    args = padded_tutorial()
    cg, err = surfdisp(*args, jnp.asarray(PERIODS), iwave=2, igr=0)
    batched = tuple(jnp.stack([a] * 5) for a in args)
    cgb, errb = surfdisp_batch(*batched, periods=jnp.asarray(PERIODS),
                               iwave=2, igr=0)
    assert np.array_equal(np.asarray(cgb), np.tile(np.asarray(cg), (5, 1)))


def test_rayleigh_halfspace_property():
    """Poisson-solid halfspace: fundamental Rayleigh c ~ 0.92 vs."""
    vs = 4.0
    vp = vs * np.sqrt(3.0)  # Poisson solid
    rho = vp * 0.32 + 0.77
    args = tuple(jnp.asarray(np.full(NL, v)) for v in
                 (0.0, vp, vs, rho))
    cg, err = surfdisp(*args, jnp.asarray(PERIODS), iwave=2, igr=0)
    assert not bool(err)
    np.testing.assert_allclose(np.asarray(cg), 0.9194 * vs, rtol=2e-3)


def test_love_halfspace_fails():
    """No Love waves exist in a halfspace — the solver must flag err
    (reference documents this failure mode, surfdisp96.f:318-323)."""
    vs = 4.0
    args = tuple(jnp.asarray(np.full(NL, v)) for v in
                 (0.0, vs * 1.73, vs, vs * 1.73 * 0.32 + 0.77))
    cg, err = surfdisp(*args, jnp.asarray(PERIODS), iwave=1, igr=0)
    assert bool(err)


def test_padding_invariance():
    """Extra zero-thickness padded slots must not change results."""
    args8 = padded_tutorial()
    cg8, _ = surfdisp(*args8, jnp.asarray(PERIODS), iwave=2, igr=0)

    NL2 = 14
    h = np.zeros(NL2)
    h[:3] = [5., 23., 8.]
    vs = np.array([2.7, 3.6, 3.8, 4.4])

    def pad(x):
        out = np.full(NL2, x[-1])
        out[:len(x)] = x
        return out

    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    args14 = tuple(jnp.asarray(v) for v in (h, pad(vp), pad(vs),
                                            pad(rho)))
    cg14, _ = surfdisp(*args14, jnp.asarray(PERIODS), iwave=2, igr=0)
    np.testing.assert_allclose(np.asarray(cg8), np.asarray(cg14),
                               atol=1e-10)


def test_spherical_flattening_shifts_up():
    args = padded_tutorial()
    cg_flat, _ = surfdisp(*args, jnp.asarray(PERIODS), iwave=2, igr=0)
    cg_sph, err = surfdisp(*args, jnp.asarray(PERIODS), iwave=2, igr=0,
                           iflsph=1)
    assert not bool(err)
    diff = np.asarray(cg_sph) - np.asarray(cg_flat)
    # sphericity raises long-period phase velocities slightly
    assert 0 < diff[-1] < 0.1


def test_higher_mode_above_fundamental():
    args = padded_tutorial()
    periods = jnp.asarray(np.linspace(1, 10, 10))
    cg1, err1 = surfdisp(*args, periods, iwave=2, igr=0, mode=1)
    cg2, err2 = surfdisp(*args, periods, iwave=2, igr=0, mode=2)
    assert not bool(err1)
    c1 = np.asarray(cg1)
    c2 = np.asarray(cg2)
    valid = c2 > 0
    assert valid.any()
    assert np.all(c2[valid] > c1[valid])


@pytest.mark.parametrize('nl_pad', [8, 21])
@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
def test_secular_invariant_to_padding(iwave, nl_pad):
    """Zero-thickness padded slots are identity propagators: from the
    unpadded 4-slot tutorial model to ``nl_pad`` slots the secular
    function keeps its sign at every candidate (its positive scale
    is arbitrary under the per-layer renormalization), and the
    solver's roots are unchanged."""
    from bayhunter_jax.ops.swd import dltar1, dltar4
    secular = dltar4 if iwave == 2 else dltar1
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77

    def pad(x, fill, n):
        return jnp.asarray(np.concatenate([x, np.full(n - x.size,
                                                      fill)]))

    omega = 2.0 * np.pi / PERIODS[:, None]
    c = np.linspace(2.0, 4.6, 261)[None, :]
    layers = {n: (pad(h, 0.0, n), pad(vp, vp[-1], n), pad(vs, vs[-1], n),
                  pad(rho, rho[-1], n)) for n in (4, nl_pad)}
    vals = {n: np.asarray(secular(jnp.asarray(omega / c),
                                  jnp.asarray(omega), *layers[n], False))
            for n in layers}
    assert np.all(np.isfinite(vals[nl_pad]))
    np.testing.assert_array_equal(vals[nl_pad] > 0, vals[4] > 0)
    roots = {n: np.asarray(surfdisp(*layers[n], jnp.asarray(PERIODS),
                                    iwave=iwave)[0]) for n in layers}
    np.testing.assert_allclose(roots[nl_pad], roots[4], atol=1e-10)
