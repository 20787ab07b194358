"""The warm dispersion solve — a ring search around the previous
model's roots, the path every model move of the sampler takes — must
land on the same roots as a cold solve of the proposed model, for
every move type at the ring width the sampler gives it
(sampler/chain.py _ring_width_for), Rayleigh and Love.

Also pins the k-section refiner's endpoint rule: a bracket with an
edge already on the root returns that edge (the closing secant can
fall outside the bracket there, and a midpoint fallback would add a
half-bracket systematic error).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bayhunter_jax.ops import swd
from bayhunter_jax.ops.voronoi import voronoi_to_layers

NL = 21
PERIODS = jnp.asarray(np.linspace(1.0, 41.0, 21), jnp.float32)
# ring half-widths of the sampler's defaults (chain._ring_width_for)
RING = {'vs': 16, 'z': 8, 'birth': 1, 'death': 1, 'vpvs': 8}


def base_models(count=8, seed=5):
    """Seeded 4-7 nucleus models around the tutorial truth."""
    rs = np.random.RandomState(seed)
    vs = np.zeros((count, NL), np.float32)
    z = np.zeros((count, NL), np.float32)
    n = np.zeros(count, np.int32)
    for i in range(count):
        k = rs.randint(4, 8)
        zi = np.sort(rs.uniform(1.0, 58.0, k))
        vi = np.interp(zi, [0, 5, 28, 36, 60], [2.7, 3.2, 3.7, 4.2, 4.4])
        vs[i, :k], z[i, :k], n[i] = vi + rs.normal(0, 0.03, k), zi, k
        vs[i, k:], z[i, k:] = vi[-1], 120.0
    return vs, z, n


def propose(kind, vs, z, n, vpvs):
    """Apply a move of ``kind`` at the sampler's proposal scale."""
    vs, z, n, vpvs = vs.copy(), z.copy(), n.copy(), vpvs.copy()
    for i in range(vs.shape[0]):
        k = n[i]
        if kind == 'vs':
            vs[i, 1] += 0.03
        elif kind == 'z':
            z[i, 1] += 0.4
        elif kind == 'birth':
            zb = 0.5 * (z[i, 0] + z[i, 1])
            zz = np.sort(np.append(z[i, :k], zb))
            vv = np.append(vs[i, :k], vs[i, 0] + 0.05)[
                np.argsort(np.append(z[i, :k], zb), kind='stable')]
            z[i, :k + 1], vs[i, :k + 1], n[i] = zz, vv, k + 1
        elif kind == 'death':
            keep = np.r_[0, 2:k]
            z[i, :k - 1], vs[i, :k - 1] = z[i, keep], vs[i, keep]
            n[i] = k - 1
        elif kind == 'vpvs':
            vpvs[i] += 0.01
    return vs, z, n, vpvs


def solve(iwave, layers, c_prev=None, ring=16):
    def one(h, vp, vs, rho, cp):
        return swd.surfdisp_roots(h, vp, vs, rho, PERIODS, c_prev=cp,
                                  iwave=iwave, warm_halfwidth=ring)
    if c_prev is None:
        return jax.vmap(lambda h, vp, vs, rho: one(h, vp, vs, rho,
                                                   None))(*layers)
    return jax.vmap(one)(*layers, c_prev)


def to_layers(vs, z, n, vpvs):
    return jax.vmap(voronoi_to_layers)(
        jnp.asarray(vs), jnp.asarray(z), jnp.asarray(n),
        jnp.asarray(vpvs))


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
@pytest.mark.parametrize('kind', list(RING))
def test_warm_solve_matches_cold(kind, iwave):
    vs, z, n = base_models()
    vpvs = np.full(vs.shape[0], 1.73, np.float32)
    _, err0, roots0 = solve(iwave, to_layers(vs, z, n, vpvs))
    assert not np.any(np.asarray(err0))
    layers = to_layers(*propose(kind, vs, z, n, vpvs))
    cg_cold, err_cold, _ = solve(iwave, layers)
    cg_warm, err_warm, _ = solve(iwave, layers, c_prev=roots0,
                                 ring=RING[kind])
    np.testing.assert_array_equal(np.asarray(err_warm),
                                  np.asarray(err_cold))
    # the two searches bracket on different DDC grids (cold from the
    # lower bound cm, warm around the previous roots), so the secant
    # polish differs at f32 rounding level only
    np.testing.assert_allclose(np.asarray(cg_warm), np.asarray(cg_cold),
                               atol=1e-5)


@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
def test_refiner_returns_root_at_bracket_edge(iwave):
    """f64: take converged roots and start the refiner with a bracket
    edge ON the root; it must return the root, not the midpoint."""
    with jax.enable_x64(True):
        vs, z, n = base_models(count=4)
        h, vp, vsl, rho = to_layers(vs.astype(np.float64),
                                    z.astype(np.float64), n,
                                    np.full(4, 1.73))
        per = jnp.asarray(np.linspace(1.0, 41.0, 21))
        secular = swd.dltar4 if iwave == 2 else swd.dltar1
        for i in range(4):
            _, err, root = swd.surfdisp_roots(h[i], vp[i], vsl[i],
                                              rho[i], per, iwave=iwave)
            assert not bool(err)
            omega = 2.0 * np.pi / per
            fn = (lambda wv, om, i=i: secular(wv, om, h[i], vp[i],
                                             vsl[i], rho[i], False))
            # the edge on the root is the bracket's lower edge where
            # the sign flips above it, else its upper edge
            up = (fn(omega / root, omega) > 0) \
                != (fn(omega / (root + swd.DDC), omega) > 0)
            lo = jnp.where(up, root, root - swd.DDC)
            c = swd._ksection_refine(omega, lo, fn, 15, 1, jnp.float64)
            # a midpoint fallback would sit ~DDC/32 = 1.6e-4 away
            np.testing.assert_allclose(np.asarray(c), np.asarray(root),
                                       atol=1e-9)
