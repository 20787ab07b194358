"""Masked Voronoi parametrization vs the host reference conversion."""

import numpy as np
import jax.numpy as jnp

from bayhunter_jax.models import Model
from bayhunter_jax.ops import voronoi

NL = 10


def random_model(rng, n):
    vs = np.sort(rng.uniform(1, 5, n))
    z = np.sort(rng.uniform(0, 60, n))
    vs_p = np.full(NL, np.nan)
    z_p = np.full(NL, np.nan)
    vs_p[:n] = vs
    z_p[:n] = z
    return vs_p, z_p, n


def test_matches_host_model_conversion():
    rng = np.random.RandomState(7)
    for n in (2, 4, 9):
        vs_p, z_p, n = random_model(rng, n)
        ref_vec = np.concatenate([vs_p[:n], z_p[:n]])
        vp_ref, vs_ref, h_ref = Model.get_vp_vs_h(ref_vec, vpvs=1.8)

        h, vp, vs_l, rho = voronoi.voronoi_to_layers(
            jnp.asarray(np.nan_to_num(vs_p)),
            jnp.asarray(np.nan_to_num(z_p)), n, 1.8)
        np.testing.assert_allclose(np.asarray(h)[:n], h_ref, atol=1e-12)
        np.testing.assert_allclose(np.asarray(vp)[:n], vp_ref,
                                   atol=1e-12)
        # padded slots replicate the halfspace, thickness 0
        assert np.all(np.asarray(h)[n - 1:] == 0)
        np.testing.assert_allclose(np.asarray(vs_l)[n:], vs_ref[-1])


def test_mantle_vpvs():
    vs = np.array([3.0, 4.0, 4.5, 4.6])
    vec = np.concatenate([vs, [10., 20., 30., 40.]])
    vp_ref, _, _ = Model.get_vp_vs_h(vec, vpvs=1.73, mantle=[4.3, 1.8])

    vs_p = np.full(NL, 4.6)
    vs_p[:4] = vs
    z_p = np.full(NL, 99.)
    z_p[:4] = [10., 20., 30., 40.]
    _, vp, _, _ = voronoi.voronoi_to_layers(
        jnp.asarray(vs_p), jnp.asarray(z_p), 4, 1.73, mantle=(4.3, 1.8))
    np.testing.assert_allclose(np.asarray(vp)[:4], vp_ref, atol=1e-12)


def test_sort_by_depth():
    vs = jnp.asarray([3.0, 2.0, 4.0, 9., 9.])
    z = jnp.asarray([30., 10., 20., 0., 0.])
    vs_s, z_s = voronoi.sort_by_depth(vs, z, 3)
    np.testing.assert_allclose(np.asarray(z_s)[:3], [10., 20., 30.])
    np.testing.assert_allclose(np.asarray(vs_s)[:3], [2.0, 4.0, 3.0])


def test_validity_checks():
    priors = {'layers': (1, 20), 'vs': (1.0, 5.0), 'z': (0.0, 60.0)}
    vs = jnp.asarray(np.full(NL, 4.0))
    z = jnp.asarray(np.linspace(5, 50, NL))

    ok = voronoi.model_is_valid(vs, z, 4, 1.73, priors, 0.0, None, None)
    assert bool(ok)

    # vs outside prior
    vs_bad = vs.at[1].set(6.0)
    assert not bool(voronoi.model_is_valid(
        vs_bad, z, 4, 1.73, priors, 0.0, None, None))

    # too few layers
    assert not bool(voronoi.model_is_valid(
        vs, z, 1, 1.73, priors, 0.0, None, None))

    # thickmin violation: three close nuclei -> interior layer between
    # midpoints is thin
    z_thin = z.at[0].set(5.0).at[1].set(5.05).at[2].set(5.1)
    assert not bool(voronoi.model_is_valid(
        vs, z_thin, 4, 1.73, priors, 1.0, None, None))

    # low-velocity zone forbidden
    vs_lvz = vs.at[1].set(2.0)
    assert not bool(voronoi.model_is_valid(
        vs_lvz, z, 4, 1.73, priors, 0.0, 0.1, None))
    # ... but allowed within percentage
    vs_lvz2 = vs.at[1].set(3.95)
    assert bool(voronoi.model_is_valid(
        vs_lvz2, z, 4, 1.73, priors, 0.0, 0.1, None))


def test_reference_vector_roundtrip():
    vs = jnp.asarray(np.full(NL, 4.0))
    z = jnp.asarray(np.linspace(5, 50, NL))
    vec = np.asarray(voronoi.to_reference_vector(vs, z, 4))
    n, vs_r, z_r = Model.split_modelparams(vec)
    assert n == 4
    np.testing.assert_allclose(vs_r, np.asarray(vs)[:4])
    np.testing.assert_allclose(z_r, np.asarray(z)[:4])
