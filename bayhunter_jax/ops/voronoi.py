"""Masked, fixed-shape Voronoi-nuclei model parametrization (pure JAX).

The transdimensional earth model is a set of ``n`` Voronoi nuclei
``(z_i, vs_i)``; layer interfaces sit at midpoints between consecutive
nuclei depths and the deepest nucleus is the halfspace (reference:
src/Models.py:16-52).  The reference NaN-pads model vectors; here every
model is a fixed-width ``(NL,)`` pair of arrays plus an integer layer
count ``n`` — entries at index ``>= n`` are padding and must never
influence results (mask semantics, XLA-friendly static shapes).

Solver-ready padding convention: the layered model handed to the
forward solvers replicates the halfspace properties into all padded
slots with zero thickness.  A zero-thickness layer contributes an
identity propagator in both the Dunkin/Thomson-Haskell recursion and
the reflectivity recursion, so padded models produce bit-identical
physics to their unpadded counterparts.
"""

from functools import partial

import jax
import jax.numpy as jnp

BIG_Z = 1e9  # sorting sentinel for padded nuclei


def sort_by_depth(vs, z, n):
    """Sort nuclei pairs by depth; padding (i >= n) stays at the end.

    Reference: src/SingleChain.py:315-328 (_sort_modelproposal).
    """
    nl = z.shape[-1]
    idx = jnp.arange(nl)
    zkey = jnp.where(idx < n, z, BIG_Z + idx)
    # variadic lax.sort carries (vs, z) as sort operands instead of
    # argsort + per-row gathers: under vmap the gathers become a
    # batched gather where the operand sort is one fused op
    # (bit-identical output; stable sort matches argsort tie order).
    _, vs_s, z_s = jax.lax.sort((zkey, vs, z), num_keys=1,
                                is_stable=True)
    return vs_s, z_s


def get_vp(vs, vpvs, n, mantle=None):
    """Vp from Vs with optional separate mantle vp/vs.

    ``mantle=(vs_threshold, mantle_vpvs)``: from the first (shallowest
    index) nucleus with ``vs >= vs_threshold`` downward, the mantle
    ratio applies.  Reference: src/Models.py:27-37.
    """
    nl = vs.shape[-1]
    idx = jnp.arange(nl)
    vp = vs * vpvs
    if mantle is None:
        return vp
    valid = idx < n
    is_m = (vs >= mantle[0]) & valid
    any_m = jnp.any(is_m)
    first_m = jnp.argmax(is_m)  # first True index (0 if none; gated by any_m)
    in_mantle = any_m & (idx >= first_m)
    return jnp.where(in_mantle, vs * mantle[1], vp)


@partial(jax.jit, static_argnames=('mantle',))
def voronoi_to_layers(vs, z, n, vpvs, mantle=None):
    """Convert a (vs, z_vnoi, n) model to solver-ready layer arrays.

    Returns ``(h, vp, vs_l, rho)`` each of shape ``(NL,)`` where:
      * ``h[i]`` is the thickness of layer i for ``i < n-1`` and 0 for
        all padded slots and the halfspace,
      * material properties at slots ``i >= n-1`` replicate the
        halfspace (nucleus ``n-1``),
      * ``rho = 0.32*vp + 0.77`` (reference: src/Targets.py:319).

    Interfaces at nuclei-depth midpoints: reference src/Models.py:40-52.
    """
    nl = vs.shape[-1]
    idx = jnp.arange(nl)
    # interface depths: z_disc[i] = (z[i] + z[i+1]) / 2 for i < n-1
    z_next = jnp.concatenate([z[1:], z[-1:]])
    z_disc = 0.5 * (z + z_next)
    z_disc_prev = jnp.concatenate([jnp.zeros_like(z_disc[:1]), z_disc[:-1]])
    h = z_disc - z_disc_prev
    h = jnp.where(idx < n - 1, h, 0.0)

    vp = get_vp(vs, vpvs, n, mantle)

    # replicate halfspace properties into padded slots.  One-hot
    # reductions instead of jnp.take: under vmap a per-chain dynamic
    # index becomes a batched gather, while the masked sum fuses into
    # the surrounding elementwise ops (exactly one index matches).
    hs = jnp.clip(n - 1, 0, nl - 1)
    hs_hot = idx == hs
    vs_hs = jnp.sum(jnp.where(hs_hot, vs, 0.0))
    vp_hs = jnp.sum(jnp.where(hs_hot, vp, 0.0))
    finite = idx < n - 1
    vs_l = jnp.where(finite, vs, vs_hs)
    vp_l = jnp.where(finite, vp, vp_hs)

    rho = vp_l * 0.32 + 0.77
    return h, vp_l, vs_l, rho


def interface_z(h, n):
    """Cumulative interface depths (masked); padded slots repeat the
    deepest interface.  Used by prior validity checks
    (reference: src/SingleChain.py:365-372)."""
    return jnp.cumsum(h)


def model_is_valid(vs, z, n, vpvs, priors, thickmin, lvz, hvz, mantle=None):
    """Vectorized prior/constraint validity of one model.

    Mirrors reference src/SingleChain.py:330-392: layer-count prior,
    minimum thickness, vs prior, interface-depth prior, optional low-
    and high-velocity-zone limits.  ``priors`` is a dict with 'layers',
    'vs', 'z' entries (host-static tuples).
    """
    nl = vs.shape[-1]
    idx = jnp.arange(nl)
    valid_mask = idx < n

    h, _, _, _ = voronoi_to_layers(vs, z, n, vpvs, mantle)

    layermin, layermax = priors['layers']
    nlayer = n - 1  # reference counts layers excluding halfspace
    ok = (nlayer >= layermin) & (nlayer <= layermax)

    # thickness: all finite layers (i < n-1) must be >= thickmin
    ok &= jnp.all(jnp.where(idx < n - 1, h, jnp.inf) >= thickmin)

    vsmin, vsmax = priors['vs']
    ok &= jnp.all(jnp.where(valid_mask, vs, vsmin) >= vsmin)
    ok &= jnp.all(jnp.where(valid_mask, vs, vsmax) <= vsmax)

    zmin, zmax = priors['z']
    zc = jnp.cumsum(h)
    zc = jnp.where(valid_mask, zc, zmin)
    ok &= jnp.all(zc >= zmin) & jnp.all(zc <= zmax)

    # low-velocity zones: vs[i+1] > vs[i] * (1 - lvz)
    pair_mask = idx < n - 1  # pairs (i, i+1) with i+1 < n
    vs_next = jnp.concatenate([vs[1:], vs[-1:]])
    if lvz is not None:
        comp = vs_next - vs * (1.0 - lvz)
        ok &= jnp.all(jnp.where(pair_mask, comp, 1.0) > 0)
    if hvz is not None:
        comp = vs * (1.0 + hvz) - vs_next
        ok &= jnp.all(jnp.where(pair_mask, comp, 1.0) > 0)

    return ok


def to_reference_vector(vs, z, n, nl=None):
    """Pack (vs, z, n) into the reference's NaN-padded flat vector
    ``[vs_0..vs_{n-1}, nan.., z_0..z_{n-1}, nan..]`` of length 2*NL
    (reference: src/mcmcOptimizer.py:92-94, src/Models.py:16-24)."""
    if nl is None:
        nl = vs.shape[-1]
    idx = jnp.arange(nl)
    mask = idx < n
    vs_p = jnp.where(mask, vs, jnp.nan)
    z_p = jnp.where(mask, z, jnp.nan)
    return jnp.concatenate([vs_p, z_p], axis=-1)
