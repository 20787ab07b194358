"""Surface-wave dispersion forward solver (pure JAX, batch-first).

Computes Love/Rayleigh phase or group velocity dispersion curves for a
stack of flat (or earth-flattened spherical) layers — the accelerator
equivalent of the reference's Fortran SURF96 solver
(reference: src/extensions/surfdisp96.f:55-1068).

Numerics match the reference:
  * Rayleigh (P-SV) secular function: Dunkin 5-component compound
    matrix recursion from the halfspace upward, with per-layer
    max-abs renormalization (reference ``dltar4``/``dnka``/``var``/
    ``normc``, surfdisp96.f:773-1068).
  * Love (SH): 2-vector Haskell recursion (reference ``dltar1``,
    surfdisp96.f:710-769).
  * Spherical earth flattening with layer-midpoint velocity mapping
    and Biswas density mapping (reference ``sphere``,
    surfdisp96.f:486-553).
  * Group velocity from two phase solves at ``t/(1±h)``, h=0.005
    (reference surfdisp96.f:232-239, 282-307).

The *root search* is redesigned for a vector machine.  The reference walks the
phase-velocity axis sequentially per period, threading the previous
period's root as a starting guess (``getsol``/``nevill``,
surfdisp96.f:390-482, 557-674) — a long serial dependence chain that
is hostile to a vector machine.  Here every period is independent:

  1. **Block bracketing with root counting.**  The secular function is
     evaluated on blocks of K phase-velocity grid points (step DDC,
     the reference's ddc) simultaneously for all periods, walking up
     from the same guaranteed lower bound ``cm`` the reference uses
     for its first period (surfdisp96.f:140-217).  The m-th sign
     change *is* the m-th mode — higher modes come from counting sign
     changes instead of the reference's fragile mode-jump guards.
  2. **K-section refinement.**  The bracket (width DDC) is narrowed by
     a factor (KR+1) per iteration by evaluating KR interior points at
     once — 3 iterations reach DDC/(KR+1)^3 ≈ 1e-6 km/s, replacing
     ~30 serial bisection steps with 3 wide vector steps.

Only the *sign* of the secular function is consumed, which is
invariant under the per-layer positive renormalization, so no
extended-exponent bookkeeping is needed.

Shape contract: all layer arrays are fixed-width ``(NL,)`` with the
halfspace in the LAST slot and zero-thickness padded slots replicating
the halfspace in between (see ops/voronoi.py).  A zero-thickness layer
contributes an identity propagator, so padding never changes results.
No data-dependent shapes anywhere; everything vmaps over a chain axis.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Optional override of the f32 refinement-pass count (see
# surfdisp_roots): the secant polish makes one sign pass enough
# for phase solves in the typical smooth case, but its worst case is
# the DDC/16 bracket width; set BAYHUNTER_NREFINE=2 (or 3) when
# inverting data whose noise floor approaches ~1e-4 km/s.
_NREFINE_ENV = os.environ.get('BAYHUNTER_NREFINE', '')
NREFINE_F32 = int(_NREFINE_ENV) if _NREFINE_ENV else None

TWOPI = 2.0 * jnp.pi
DDC = 0.005          # phase-velocity grid step (surfdisp96.f:126)
HGR = 0.005          # group-velocity frequency increment (surfdisp96.f:128)
EARTH_R = 6370.0     # sphere(): ar (surfdisp96.f:517)


# --------------------------------------------------------------------------
# secular functions — candidate-parallel over arbitrary wvno shapes
# --------------------------------------------------------------------------

def _vertical_wavenumber(wvno, xk):
    """r = sqrt(|wvno^2 - xk^2|) via the reference's (wvno+xk)(|wvno-xk|)
    product form (surfdisp96.f:790-795)."""
    return jnp.sqrt((wvno + xk) * jnp.abs(wvno - xk))


def _var_quantities(pq, r, wvno, xk, dpth):
    """Scaled cosP/sinP eigenfunction quantities for one wave type.

    Port of the P- or S-half of subroutine ``var``
    (surfdisp96.f:874-991).  Returns (cos_, w_, x_, exponent) where for
    the evanescent regime cos/sin carry an implicit factor exp(+pq)
    tracked in ``exponent``.  Only relative magnitudes and signs reach
    the root finder, so the exponent is used solely to combine P and S
    scalings consistently inside one layer.
    """
    prop = wvno < xk  # propagating regime
    r_safe = jnp.where(r == 0.0, 1.0, r)

    sin_p = jnp.sin(pq)
    w_prop = jnp.where(r == 0.0, dpth, sin_p / r_safe)
    x_prop = -r * sin_p
    cos_prop = jnp.cos(pq)

    fac = jnp.where(pq < 16.0, jnp.exp(-2.0 * pq), 0.0)
    cos_ev = 0.5 * (1.0 + fac)
    sin_ev = 0.5 * (1.0 - fac)
    w_ev = jnp.where(r == 0.0, dpth, sin_ev / r_safe)
    x_ev = r * sin_ev

    cos_ = jnp.where(prop, cos_prop, cos_ev)
    w_ = jnp.where(prop, w_prop, w_ev)
    x_ = jnp.where(prop, x_prop, x_ev)
    ex = jnp.where(prop, 0.0, pq)
    return cos_, w_, x_, ex


def _dnka_apply(e, wvno2, gam, gammk, rho, a0, cpcq, cpy, cpz, cqw, cqx,
                xy, xz, wy, wz):
    """Apply Dunkin's 5x5 compound matrix to the E row-vector:
    ``e_new_j = sum_i e_i * ca_ij`` (surfdisp96.f:1024-1068).

    The matrix is never materialized — the 25 entries (with their
    symmetry shortcuts) contract against ``e`` (a 5-tuple of
    candidate-shaped arrays) elementwise, keeping the whole recursion
    on the VPU instead of MXU-padded tiny dot ops.
    """
    one, two = 1.0, 2.0
    gamm1 = gam - one
    twgm1 = gam + gamm1
    gmgmk = gam * gammk
    gmgm1 = gam * gamm1
    gm1sq = gamm1 * gamm1
    rho2 = rho * rho
    a0pq = a0 - cpcq

    ca11 = cpcq - two * gmgm1 * a0pq - gmgmk * xz - wvno2 * gm1sq * wy
    ca12 = (wvno2 * cpy - cqx) / rho
    ca13 = -(twgm1 * a0pq + gammk * xz + wvno2 * gamm1 * wy) / rho
    ca14 = (cpz - wvno2 * cqw) / rho
    ca15 = -(two * wvno2 * a0pq + xz + wvno2 * wvno2 * wy) / rho2
    ca21 = (gmgmk * cpz - gm1sq * cqw) * rho
    ca22 = cpcq
    ca23 = gammk * cpz - gamm1 * cqw
    ca24 = -wz
    ca25 = ca14
    ca41 = (gm1sq * cpy - gmgmk * cqx) * rho
    ca42 = -xy
    ca43 = gamm1 * cpy - gammk * cqx
    ca44 = ca22
    ca45 = ca12
    ca51 = -(two * gmgmk * gm1sq * a0pq + gmgmk * gmgmk * xz
             + gm1sq * gm1sq * wy) * rho2
    ca52 = ca41
    ca53 = -(gammk * gamm1 * twgm1 * a0pq + gam * gammk * gammk * xz
             + gamm1 * gm1sq * wy) * rho
    ca54 = ca21
    ca55 = ca11
    t = -two * wvno2
    ca31 = t * ca53
    ca32 = t * ca43
    ca33 = a0 + two * (cpcq - ca11)
    ca34 = t * ca23
    ca35 = t * ca13

    e1, e2, e3, e4, e5 = e
    return (e1 * ca11 + e2 * ca21 + e3 * ca31 + e4 * ca41 + e5 * ca51,
            e1 * ca12 + e2 * ca22 + e3 * ca32 + e4 * ca42 + e5 * ca52,
            e1 * ca13 + e2 * ca23 + e3 * ca33 + e4 * ca43 + e5 * ca53,
            e1 * ca14 + e2 * ca24 + e3 * ca34 + e4 * ca44 + e5 * ca54,
            e1 * ca15 + e2 * ca25 + e3 * ca35 + e4 * ca45 + e5 * ca55)


def dltar4(wvno, omega, d, a, b, rho, water):
    """Rayleigh-wave period (secular) equation.

    Port of ``dltar4`` (surfdisp96.f:773-871), candidate-parallel:
    ``wvno``/``omega`` may have any (broadcastable) shape S;
    ``d,a,b,rho`` are ``(NL,)`` padded layer arrays with the halfspace
    in the last slot; ``water`` is a boolean scalar (surface water
    layer present).  Returns shape-S values whose sign matches the
    reference; the positive scale is arbitrary due to per-layer
    renormalization.
    """
    return _dltar4_impl(wvno, omega, d, a, b, rho, water)


def _dltar4_impl(wvno, omega, d, a, b, rho, water):
    omega = jnp.maximum(omega, 1.0e-4)
    wvno, omega = jnp.broadcast_arrays(wvno, omega)
    wvno2 = wvno * wvno

    # halfspace E vector (surfdisp96.f:798-808)
    ra_hs = _vertical_wavenumber(wvno, omega / a[-1])
    rb_hs = _vertical_wavenumber(wvno, omega / b[-1])
    t_hs = b[-1] / omega
    gammk_hs = 2.0 * t_hs * t_hs
    gam_hs = gammk_hs * wvno2
    gamm1_hs = gam_hs - 1.0
    rho_hs = rho[-1]
    e = (rho_hs * rho_hs * (gamm1_hs * gamm1_hs
                            - gam_hs * gammk_hs * ra_hs * rb_hs),
         (-rho_hs * ra_hs).astype(wvno.dtype),
         rho_hs * (gamm1_hs - gammk_hs * ra_hs * rb_hs),
         (rho_hs * rb_hs).astype(wvno.dtype),
         wvno2 - ra_hs * rb_hs)  # 5-tuple, each shape S

    nl = d.shape[-1]
    # propagate from the layer above the halfspace (slot NL-2) up to the
    # surface (slot 0); a surface water layer (slot 0) is skipped here
    # and handled by the water boundary below.
    order = jnp.arange(nl - 2, -1, -1)
    xs = (d[order], a[order], b[order], rho[order],
          water & (order == 0))

    def step(ee, layer):
        d_l, a_l, b_l, rho_l, skip = layer
        xka = omega / a_l
        xkb = omega / b_l
        ra = _vertical_wavenumber(wvno, xka)
        rb = _vertical_wavenumber(wvno, xkb)
        t_l = b_l / omega
        gammk = 2.0 * t_l * t_l
        gam = gammk * wvno2

        cosp, w, x, pex = _var_quantities(ra * d_l, ra, wvno, xka, d_l)
        cosq, y, z, sex = _var_quantities(rb * d_l, rb, wvno, xkb, d_l)
        exa = pex + sex
        a0 = jnp.where(exa < 60.0, jnp.exp(-exa), 0.0)

        een = _dnka_apply(ee, wvno2, gam, gammk, rho_l, a0,
                          cosp * cosq, cosp * y, cosp * z, cosq * w,
                          cosq * x, x * y, x * z, w * y, w * z)
        nrm = jnp.abs(een[0])
        for comp in een[1:]:
            nrm = jnp.maximum(nrm, jnp.abs(comp))
        nrm = jnp.where(nrm < 1e-40, 1.0, nrm)
        out = tuple(jnp.where(skip, ec, en / nrm)
                    for ec, en in zip(ee, een))
        return out, None

    e, _ = lax.scan(step, e, xs)

    # water-layer surface boundary (surfdisp96.f:850-869)
    ra0 = _vertical_wavenumber(wvno, omega / a[0])
    cosp_w, w_w, _, _ = _var_quantities(ra0 * d[0], ra0, wvno,
                                        omega / a[0], d[0])
    w0 = -rho[0] * w_w
    return jnp.where(water, cosp_w * e[0] + w0 * e[1], e[0])


def dltar1(wvno, omega, d, a, b, rho, water):
    """Love-wave period (secular) equation.

    Port of ``dltar1`` (surfdisp96.f:710-769): 2-vector Haskell
    recursion from the halfspace up, with per-layer renormalization,
    candidate-parallel over the shape of ``wvno``.  A surface water
    layer is skipped (llw=2 semantics).
    """
    return _dltar1_impl(wvno, omega, d, a, b, rho, water)


def _dltar1_impl(wvno, omega, d, a, b, rho, water):
    wvno, omega = jnp.broadcast_arrays(wvno, omega)
    rb_hs = _vertical_wavenumber(wvno, omega / b[-1])
    e1 = (rho[-1] * rb_hs).astype(wvno.dtype)
    e2 = jnp.broadcast_to(
        jnp.asarray(1.0 / (b[-1] * b[-1]), wvno.dtype), wvno.shape)

    nl = d.shape[-1]
    order = jnp.arange(nl - 2, -1, -1)
    xs = (d[order], b[order], rho[order], water & (order == 0))

    def step(carry, layer):
        e1c, e2c = carry
        d_l, b_l, rho_l, skip = layer
        xkb = omega / b_l
        rb = _vertical_wavenumber(wvno, xkb)
        xmu = rho_l * b_l * b_l
        cosq, y, z, _ = _var_quantities(rb * d_l, rb, wvno, xkb,
                                        d_l)
        e10 = e1c * cosq + e2c * xmu * z
        e20 = e1c * y / xmu + e2c * cosq
        nrm = jnp.maximum(jnp.abs(e10), jnp.abs(e20))
        nrm = jnp.where(nrm < 1e-40, 1.0, nrm)
        e1n = jnp.where(skip, e1c, e10 / nrm)
        e2n = jnp.where(skip, e2c, e20 / nrm)
        return (e1n, e2n), None

    (e1, e2), _ = lax.scan(step, (e1, e2), xs)
    return e1


# --------------------------------------------------------------------------
# starting solution & flattening
# --------------------------------------------------------------------------

def gtsolh(a, b):
    """Halfspace Rayleigh-velocity starting solution: 5 Newton steps on
    the halfspace period equation (surfdisp96.f:367-388)."""
    c = 0.95 * b
    for _ in range(5):
        gamma = b / a
        kappa = c / b
        k2 = kappa * kappa
        gk2 = (gamma * kappa) ** 2
        fac1 = jnp.sqrt(jnp.maximum(1.0 - gk2, 1e-30))
        fac2 = jnp.sqrt(jnp.maximum(1.0 - k2, 1e-30))
        fr = (2.0 - k2) ** 2 - 4.0 * fac1 * fac2
        frp = (-4.0 * (2.0 - k2) * kappa
               + 4.0 * fac2 * gamma * gamma * kappa / fac1
               + 4.0 * fac1 * kappa / fac2)
        frp = frp / b
        c = c - fr / frp
    return c


def sphere_flatten(d, a, b, rho, iwave):
    """Spherical-earth to flat-earth transform (surfdisp96.f:486-553).

    Layer-midpoint velocity mapping; Biswas density mapping with
    exponent -5 (Love) or -2.275 (Rayleigh).  The halfspace slot uses a
    fictitious 1 km thickness for its midpoint, exactly as the
    reference (surfdisp96.f:519).  Zero-thickness padded slots keep
    zero thickness.
    """
    d_eff = d.at[-1].set(1.0)
    zb = jnp.cumsum(d_eff)            # bottom depth of each layer
    zt = zb - d_eff                   # top depth
    r0 = EARTH_R - zt
    r1 = EARTH_R - zb
    z0 = EARTH_R * jnp.log(EARTH_R / r0)
    z1 = EARTH_R * jnp.log(EARTH_R / r1)
    d_f = z1 - z0
    tmp = (EARTH_R + EARTH_R) / (r0 + r1)
    a_f = a * tmp
    b_f = b * tmp
    ex = -5.0 if iwave == 1 else -2.275
    rho_f = rho * tmp ** ex
    d_f = d_f.at[-1].set(0.0)
    return d_f, a_f, b_f, rho_f


# --------------------------------------------------------------------------
# period-parallel root search
# --------------------------------------------------------------------------

def _find_brackets(omega, cm, betmx, secular, mode, K, nblocks, dtype,
                   found0=None, lo0=None):
    """Locate the ``mode``-th sign change of ``secular`` in c for every
    period simultaneously.

    Walks blocks of K grid points (step DDC) upward from ``cm`` —
    the reference's guaranteed lower bound for the fundamental
    (surfdisp96.f:140-217) — counting sign changes; the m-th change
    brackets the m-th mode.  Returns (lo, found): bracket lower edges
    (width DDC) and success flags, both shaped like ``omega``.

    ``found0``/``lo0`` seed already-bracketed lanes (warm start); when
    every lane is seeded the while loop exits after one condition
    check.
    """
    P = omega.shape
    dc = jnp.asarray(DDC, dtype)
    koff = (jnp.arange(1, K + 1, dtype=dtype)) * dc  # (K,)

    sign0 = secular(omega / cm, omega) > 0           # (P,)

    def cond(st):
        j, _, _, found, _ = st
        base = cm + (j * K) * dc
        dead = base > betmx + dc
        return (j < nblocks) & jnp.logical_not(jnp.all(found | dead))

    def body(st):
        j, prev_sign, cnt, found, lo = st
        base = cm + (j * K) * dc
        c = base + koff                               # (K,)
        valid = c <= betmx + dc                       # (K,)
        sg = secular(omega[..., None] / c, omega[..., None]) > 0
        allsg = jnp.concatenate([prev_sign[..., None], sg], axis=-1)
        flips = (allsg[..., 1:] != allsg[..., :-1]) & valid
        cum = cnt[..., None] + jnp.cumsum(flips, axis=-1,
                                          dtype=jnp.int32)
        hit = (cum == mode) & flips                   # (P, K)
        has_hit = jnp.any(hit, axis=-1)
        idx = jnp.argmax(hit, axis=-1)                # first hit
        lo_new = base + idx * dc                      # c[idx] - dc
        newly = has_hit & jnp.logical_not(found)
        lo = jnp.where(newly, lo_new, lo)
        found = found | newly
        cnt = cum[..., -1]
        return (j + 1, sg[..., -1], cnt, found, lo)

    if found0 is None:
        found0 = jnp.zeros(P, bool)
        lo0 = jnp.full(P, cm, dtype)
    st0 = (jnp.asarray(0), sign0, jnp.zeros(P, jnp.int32), found0,
           jnp.broadcast_to(lo0, P))
    _, _, _, found, lo = lax.while_loop(cond, body, st0)
    return lo, found


def _ring_brackets(omega, c_prev, cm, betmx, secular, K, max_trips,
                   dtype):
    """Bracket the sign change NEAREST to a previous solution
    ``c_prev`` by searching expanding rings of K grid points (step
    DDC) on each side.

    McMC proposals perturb the model slightly, so the new root almost
    always lies within the first ring — one vector evaluation replaces
    the full upward walk.  Lanes that miss keep expanding outward; the
    search only degenerates to a full-range sweep for pathological
    moves, and a vmapped batch only pays extra trips when some chain
    actually needs them (unlike a full-restart fallback, which the
    whole batch would pay for whenever ANY lane misses — the miss
    probability of any fixed window approaches 1 as chains x periods
    grows).

    The secular kernel is VPU-compute-bound but carries a fixed
    per-invocation cost, so the center-point sign (needed to detect
    flips) is FUSED into the first trip's point set instead of being
    a separate kernel call — the extra lane per period pads into the
    same 128-lane tile, making the fusion free.

    Tracking the nearest root follows the reference's own warm-start
    semantics (``getsol`` walks from just below the previous period's
    root with a direction guard, surfdisp96.f:390-447); for the
    fundamental mode the nearest sign change IS the fundamental, since
    no roots exist below it.  Returns (lo, found).
    """
    P = omega.shape
    dc = jnp.asarray(DDC, dtype)
    ksteps = jnp.arange(1, K + 1, dtype=dtype) * dc   # (K,)

    def cond(st):
        t, _, _, found, dead, _ = st
        return (t < max_trips) & jnp.logical_not(jnp.all(found | dead))

    def body(st):
        t, sL, sR, found, dead, lo = st
        base = (t * K) * dc
        ptsR = c_prev[..., None] + base + ksteps      # (P, K) ascending
        ptsL = c_prev[..., None] - base - ksteps      # (P, K) descending

        validR = ptsR <= betmx + dc
        validL = ptsL >= cm
        # c_prev rides along in every trip: on trip 0 its sign seeds
        # the flip chains (sL/sR enter the loop unknown); afterwards
        # it is dead weight that pads into the same kernel tile
        pts = jnp.concatenate([c_prev[..., None], ptsR, ptsL],
                              axis=-1)
        sg = secular(omega[..., None] / pts, omega[..., None]) > 0
        s0 = sg[..., 0]
        sgR, sgL = sg[..., 1:K + 1], sg[..., K + 1:]
        first = t == 0
        sR_c = jnp.where(first, s0, sR)
        sL_c = jnp.where(first, s0, sL)

        allR = jnp.concatenate([sR_c[..., None], sgR], axis=-1)
        flipR = (allR[..., 1:] != allR[..., :-1]) & validR
        allL = jnp.concatenate([sL_c[..., None], sgL], axis=-1)
        flipL = (allL[..., 1:] != allL[..., :-1]) & validL

        jR = jnp.argmax(flipR, axis=-1)
        jL = jnp.argmax(flipL, axis=-1)
        hasR = jnp.any(flipR, axis=-1)
        hasL = jnp.any(flipL, axis=-1)
        # bracket lower edges: right flip j -> [pt_j - dc, pt_j];
        # left flip j -> [pt_j, pt_j + dc]
        loR = jnp.take_along_axis(ptsR, jR[..., None],
                                  axis=-1)[..., 0] - dc
        loL = jnp.take_along_axis(ptsL, jL[..., None], axis=-1)[..., 0]
        # prefer the nearer side; ties go up (reference walks upward)
        useL = hasL & (jnp.logical_not(hasR) | (jL < jR))
        lo_new = jnp.where(useL, loL, loR)
        newly = (hasR | hasL) & jnp.logical_not(found)
        lo = jnp.where(newly, lo_new, lo)
        found = found | newly

        dead = dead | (jnp.logical_not(validR[..., 0])
                       & jnp.logical_not(validL[..., 0]))
        # frontier signs advance only while in range
        sR = jnp.where(validR[..., -1], sgR[..., -1], sR_c)
        sL = jnp.where(validL[..., -1], sgL[..., -1], sL_c)
        return (t + 1, sL, sR, found, dead, lo)

    sfalse = jnp.zeros(P, bool)
    st0 = (jnp.asarray(0), sfalse, sfalse, jnp.zeros(P, bool),
           jnp.zeros(P, bool), jnp.full(P, cm, dtype))
    _, _, _, found, _, lo = lax.while_loop(cond, body, st0)
    return lo, found


def _ksection_refine(omega, lo, secular, KR, niter, dtype):
    """Narrow a (lo, lo+DDC) bracket by (KR+1)^niter via simultaneous
    evaluation of KR+1 grid points per iteration (the wide-vector
    replacement of the reference's ``nevill`` serial refinement),
    then polish with one secant step on the final bracket's secular
    VALUES — they come out of the same kernel calls for free.

    The renormalized secular value is continuous in c (the per-layer
    norms are maxima of continuous functions), so secant inside a
    sign-confirmed bracket converges quadratically in the typical
    smooth case and is safely clamped to the bracket otherwise —
    the pure-sign resolution DDC/(KR+1)^niter stays the worst-case
    guarantee.
    """
    dc = jnp.asarray(DDC, dtype)
    hi = lo + dc
    # fracs 0..1 inclusive: the bracket bottom (frac 0) rides along in
    # the SAME kernel call as the KR interior points and the top —
    # its value supplies the flip-direction sign and the secant's
    # f_lo, eliminating the separate f_lo kernel invocation (the
    # extra lane per period pads into the same 128-lane tile)
    fracs = jnp.arange(0, KR + 2, dtype=dtype) / (KR + 1)  # (KR+2,)

    def body(_, st):
        lo_c, hi_c, f_lo_c, f_hi_c = st
        pts = lo_c[..., None] + (hi_c - lo_c)[..., None] * fracs
        vals = secular(omega[..., None] / pts, omega[..., None])
        s_lo = vals[..., 0] > 0
        diff = (vals[..., 1:] > 0) != s_lo[..., None]  # (P, KR+1)
        idx = jnp.argmax(diff, axis=-1)               # first flip
        # no flip found (all same sign, can happen on a degenerate
        # bracket): keep the top point so the bracket stays put
        idx = jnp.where(jnp.any(diff, axis=-1), idx, KR)
        hi_n = jnp.take_along_axis(pts[..., 1:], idx[..., None],
                                   axis=-1)[..., 0]
        f_hi_n = jnp.take_along_axis(vals[..., 1:], idx[..., None],
                                     axis=-1)[..., 0]
        # new-lo candidates are fracs 0..KR (the point below each flip)
        lo_n = jnp.take_along_axis(pts[..., :-1], idx[..., None],
                                   axis=-1)[..., 0]
        f_lo_n = jnp.take_along_axis(vals[..., :-1], idx[..., None],
                                     axis=-1)[..., 0]
        return lo_n, hi_n, f_lo_n, f_hi_n

    zero_f = jnp.zeros(jnp.broadcast_shapes(lo.shape, omega.shape),
                       dtype)
    st0 = (lo, hi, zero_f, zero_f)
    lo, hi, f_lo, f_hi = lax.fori_loop(0, niter, body, st0)

    denom = f_hi - f_lo
    denom = jnp.where(denom == 0.0, 1.0, denom)
    c = lo - f_lo * (hi - lo) / denom
    # out-of-bracket fallback: with opposite-sign endpoint values the
    # secant is mathematically interior, so falling outside means an
    # endpoint value is (numerically) zero — i.e. an endpoint IS the
    # root (a warm start on a converged root lands there).  The
    # midpoint would re-introduce a width/2 systematic error; return
    # the smaller-|f| endpoint instead.
    edge = jnp.where(jnp.abs(f_lo) <= jnp.abs(f_hi), lo, hi)
    good = (c > lo) & (c < hi) & jnp.isfinite(c)
    return jnp.where(good, c, edge)


# --------------------------------------------------------------------------
# public driver
# --------------------------------------------------------------------------

def surfdisp_roots(h, vp, vs, rho, periods, c_prev=None, iwave=2,
                   mode=1, igr=0, iflsph=0, kblock=64, nblocks=16,
                   krefine=15, nrefine=None, warm_halfwidth=16,
                   warm_max_trips=None):
    """Like :func:`surfdisp` but also returns the refined
    phase-velocity roots for warm-starting a subsequent solve.

    ``c_prev`` (optional) carries the previous solve's roots — shape
    (P,) for phase targets and (2P,) for group targets (the two
    t/(1±h) solves).  Warm lanes bracket in one 2*warm_halfwidth+1
    point evaluation around ``c_prev``; missed lanes fall back to the
    full counting search.  Returns ``(cg, err, roots)``.
    """
    dtype = h.dtype
    if nrefine is None:
        # the closing secant polish carries f32 phase solves with one
        # sign pass (NREFINE_F32 above); f64 and group solves keep 3
        nrefine = 3 if (dtype == jnp.float64 or igr > 0) \
            else (NREFINE_F32 or 1)

    if iflsph == 1:
        d, a, b, rho_w = sphere_flatten(h, vp, vs, rho, iwave)
    else:
        d, a, b, rho_w = h, vp, vs, rho

    water = b[0] <= 0.0

    # extremal velocities & lower bound cm (surfdisp96.f:140-217)
    solid = b > 0.01
    cand = jnp.where(solid, b, a)
    jmn = jnp.argmin(cand)
    betmn = cand[jmn]
    jsol = solid[jmn]
    betmx = jnp.max(b)

    cc1 = jnp.where(jsol, gtsolh(a[jmn], b[jmn]), betmn)
    cm = (0.95 * 0.90 * cc1).astype(dtype)

    if iwave == 1:
        def secular(wvno, omega):
            return dltar1(wvno, omega, d, a, b, rho_w, water)
    else:
        def secular(wvno, omega):
            return dltar4(wvno, omega, d, a, b, rho_w, water)

    t = periods.astype(dtype)
    if igr > 0:
        # two phase solves at t/(1±h) (surfdisp96.f:232-239)
        t1a = t / (1.0 + HGR)
        t1b = t / (1.0 - HGR)
        omegas = TWOPI / jnp.concatenate([t1a, t1b])
    else:
        omegas = TWOPI / t

    if c_prev is not None:
        # warm path: a few expanding rings around the previous roots
        # (small perturbations exit after ring 1), then the 64-wide
        # counting search ONLY for lanes whose root jumped far —
        # heavy-tailed under birth/death moves — where the wide walk
        # from cm is cheaper than a long ring expansion
        cp = jnp.clip(c_prev.astype(dtype), cm, betmx)
        if warm_max_trips is None:
            # pure ring: expand until the root is found or the range
            # is exhausted (measured fastest — a counting-search
            # fallback re-pays the full sweep whenever ANY lane in the
            # batch misses, which at large batches is every
            # birth/death iteration)
            trips = max(1, (kblock * nblocks) // warm_halfwidth)
            lo, found = _ring_brackets(omegas, cp, cm, betmx, secular,
                                       warm_halfwidth, trips, dtype)
        else:
            lo0, found0 = _ring_brackets(omegas, cp, cm, betmx,
                                         secular, warm_halfwidth,
                                         warm_max_trips, dtype)
            lo, found = _find_brackets(omegas, cm, betmx, secular,
                                       mode, kblock, nblocks, dtype,
                                       found0=found0, lo0=lo0)
    else:
        lo, found = _find_brackets(omegas, cm, betmx, secular, mode,
                                   kblock, nblocks, dtype)
    c = _ksection_refine(omegas, lo, secular, krefine, nrefine, dtype)

    nper = t.shape[0]
    if igr > 0:
        ca, cb = c[:nper], c[nper:]
        ok = found[:nper] & found[nper:]
        gvel = ((1.0 / t1a - 1.0 / t1b)
                / (1.0 / (t1a * ca) - 1.0 / (t1b * cb)))
        out = gvel
    else:
        ok = found
        out = c

    # zero-fill from the first failing period on (surfdisp96.f:313-354)
    failed_cum = jnp.cumsum(jnp.logical_not(ok)) > 0
    cg = jnp.where(failed_cum, 0.0, out)
    err = jnp.any(jnp.logical_not(ok))
    return cg, err, c


@partial(jax.jit,
         static_argnames=('iwave', 'mode', 'igr', 'iflsph', 'kblock',
                          'nblocks', 'krefine', 'nrefine'))
def surfdisp(h, vp, vs, rho, periods, iwave=2, mode=1, igr=0, iflsph=0,
             kblock=64, nblocks=16, krefine=15, nrefine=None):
    """Dispersion curve for one padded layer model.

    Arguments mirror the reference entry point
    (surfdisp96.f:55-56 / src/surf96_modsw.py:84-126):

      h, vp, vs, rho : (NL,) padded layer arrays, halfspace last
      periods        : (P,) periods in s (monotone increasing)
      iwave          : 1 Love, 2 Rayleigh
      mode           : 1 fundamental, 2 first higher, ...
      igr            : 0 phase velocity, >0 group velocity
      iflsph         : 0 flat earth, 1 spherical (flattening applied)

    Tuning (static): ``kblock`` grid points per bracketing block,
    ``nblocks`` max blocks (kblock*nblocks*DDC must cover the root
    range — defaults span 5.1 km/s), ``krefine``/``nrefine`` K-section
    refinement width/iterations.

    Returns ``(cg, err)`` with ``cg`` shape (P,) phase/group velocities
    (zeros after the first failed period, as the reference) and ``err``
    True if any period failed (the reference plugin then returns NaN
    data; src/surf96_modsw.py:119-126).

    Batch with ``jax.vmap`` over the leading model axes.
    """
    cg, err, _ = surfdisp_roots(
        h, vp, vs, rho, periods, c_prev=None, iwave=iwave, mode=mode,
        igr=igr, iflsph=iflsph, kblock=kblock, nblocks=nblocks,
        krefine=krefine, nrefine=nrefine)
    return cg, err


def surfdisp_batch(h, vp, vs, rho, periods, **kwargs):
    """vmap of :func:`surfdisp` over a leading chain axis."""
    fn = partial(surfdisp, periods=periods, **kwargs)
    return jax.vmap(lambda hh, pp, ss, rr: fn(hh, pp, ss, rr))(
        h, vp, vs, rho)
