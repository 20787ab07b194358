"""Receiver-function synthesizer: plane-wave reflectivity (pure JAX).

Accelerator equivalent of the reference's C++ ``rfmini`` extension
(reference: src/extensions/rfmini/greens.cpp, model.cpp, synrf.cpp,
wrap.cpp).  Method: frequency-domain transmission response of a layered
halfspace via the recursive reflectivity of Mueller (1985), free-surface
displacement conversion, Z/R → P/SV decomposition, spectral-division
deconvolution with Gauss low-pass, inverse real FFT.

Design notes:
  * The C++ frequency loop (greens.cpp:528-585) becomes a fully
    vectorized frequency axis — every per-layer 2x2 complex operation
    acts on an (nfreq,) vector; only the layer recursion is a
    ``lax.scan`` (sequential by physics).
  * Fixed shapes: layer arrays are (NL,) padded with zero-thickness
    copies of the halfspace (see ops/voronoi.py).  A zero-thickness
    layer between identical media has R=0, T=I, E=I — the recursion
    passes through unchanged, so padding is exact.
  * The radix-2 C++ FFT (fork.cpp) with its 1/sqrt(n) convention
    composes with the extra 1/sqrt(n) of greens.cpp:iftr to exactly
    ``jnp.fft.irfft``.
  * Complex dtype follows the input real dtype (complex64 for the
    float32 production path).

Fidelity notes (kept deliberately identical to the reference):
  * The waterlevel parameter is accepted but NOT applied in the
    deconvolution — the reference comments it out
    (greens.cpp:375-384).
  * R/T interface coefficients use real (elastic) velocities; only the
    phase matrices use the anelastic complex velocities of Mueller
    eq. 132 (greens.cpp:462-467 vs 536-543).
  * The direct-wave alignment time t0 includes the halfspace with its
    h=-1 sentinel (greens.cpp:509-526 with model.cpp's h=-1); this
    cancels in the receiver function and only shifts fz/fr.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

EARTH_R = 6371.0          # model.cpp:167 (note: 6371, not surf96's 6370)
DEG_PER_KM = 0.00899      # wrap.cpp:55
P_WAVE, SV_WAVE, SH_WAVE = 0, 1, 2

# solver option flags (synrf.h:52-53).  SUPPRESS_MULTIPLES drops the
# reverberation operator from the top-down recursion — with default-
# zero nb (cmat2.h default ctor) the reference's greens.cpp:212-216
# reduces the response to the pure direct downward transmission
# g = prod_i e_i tu_{i+1}.  WITHOUT_ANELASTICITY is DORMANT in the
# reference (defined, never consumed in greens.cpp); here it applies
# the documented intent — real elastic velocities in the phase
# matrices (the Q -> inf limit of Mueller eq. 132).
SUPPRESS_MULTIPLES = 1
WITHOUT_ANELASTICITY = 2


# ----------------------------------------------------------------------
# small complex 2x2 helpers — matrices stored as (..., 2, 2)
# ----------------------------------------------------------------------

def _mat(c11, c12, c21, c22):
    row1 = jnp.stack([c11, c12], axis=-1)
    row2 = jnp.stack([c21, c22], axis=-1)
    return jnp.stack([row1, row2], axis=-2)


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    q = 1.0 / det
    return _mat(q * m[..., 1, 1], -q * m[..., 0, 1],
                -q * m[..., 1, 0], q * m[..., 0, 0])


def _exe(e, x):
    """e @ x @ e for diagonal e — greens.cpp:829-845."""
    e11 = e[..., 0]
    e22 = e[..., 1]
    e12 = e11 * e22
    return _mat(x[..., 0, 0] * e11 * e11, x[..., 0, 1] * e12,
                x[..., 1, 0] * e12, x[..., 1, 1] * e22 * e22)


def _sqrt_relu(x):
    """sqrt(max(x, 0)) with a differentiation-safe zero branch: the
    plain composition has a 0*inf = NaN tangent wherever the clamp is
    active, which poisons jax.linearize through the solver
    (ops/rf_pd.py).  Double-where keeps the primal bit-identical and
    the tangent zero on the clamped side."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def _csqrt_conj(x, cdtype):
    """conj(sqrt(complex(x))) for real x: -i*sqrt(-x) when x < 0."""
    return (_sqrt_relu(x) - 1j * _sqrt_relu(-x)).astype(cdtype)


def _csqrt_plain(x, cdtype):
    """sqrt(complex(x)) for real x: +i*sqrt(-x) when x < 0."""
    return (_sqrt_relu(x) + 1j * _sqrt_relu(-x)).astype(cdtype)


# ----------------------------------------------------------------------
# interface R/T coefficients (real elastic velocities)
# ----------------------------------------------------------------------

def coeff(p, vp1, vs1, rh1, vp2, vs2, rh2, dis=1):
    """R/T coefficient introspection, rfmini-compatible.

    Mirrors ``rfmini.coeff`` (reference: rfmini.pyx:252-314 ->
    wrap.cpp:91-153): plane-wave reflection/transmission coefficients
    at a welded interface between two halfspaces, as five 4-tuples of
    complex values ``(rd, td, ru, tu, sh)`` with each P-SV tuple in
    (11, 12, 21, 22) order and ``sh = (rhd, thd, rhu, thu)``.
    ``dis`` nonzero returns displacement coefficients (the wrap.cpp
    velocity-ratio rescaling); 0 returns potential coefficients.
    """
    rd, td, ru, tu = (np.array(m) for m in interface_coefficients(
        p, vp1, vs1, rh1, vp2, vs2, rh2, jnp.complex128))
    if dis:
        ru[..., 0, 1] *= vs2 / vp2
        ru[..., 1, 0] *= vp2 / vs2
        tu[..., 0, 0] *= vp2 / vp1
        tu[..., 0, 1] *= vs2 / vp1
        tu[..., 1, 0] *= vp2 / vs1
        tu[..., 1, 1] *= vs2 / vs1
        rd[..., 0, 1] *= vs1 / vp1
        rd[..., 1, 0] *= vp1 / vs1
        td[..., 0, 0] *= vp1 / vp2
        td[..., 0, 1] *= vs1 / vp2
        td[..., 1, 0] *= vp1 / vs2
        td[..., 1, 1] *= vs1 / vs2
    rhd, thd, rhu, thu = (complex(np.asarray(v)) for v in
                          interface_coefficients_sh(
                              p, vs1, rh1, vs2, rh2, jnp.complex128))

    def tup(m):
        return (complex(m[0, 0]), complex(m[0, 1]),
                complex(m[1, 0]), complex(m[1, 1]))

    return tup(rd), tup(td), tup(ru), tup(tu), (rhd, thd, rhu, thu)


def coeffs(p, vp, vs, rh=None):
    """Free-surface reflection introspection, rfmini-compatible.

    Mirrors ``rfmini.coeffs`` (reference: rfmini.pyx:316-331 ->
    greens.cpp:87-112): returns ``((ru11, ru12, ru21, ru22), rhu)``
    with total SH reflection ``rhu = 1``.  ``rh`` is accepted for
    signature parity but unused (as in the reference).
    """
    ru = np.asarray(free_surface_reflection(p, vp, vs, jnp.complex128))
    return ((complex(ru[0, 0]), complex(ru[0, 1]),
             complex(ru[1, 0]), complex(ru[1, 1])), complex(1.0, 0.0))

def interface_coefficients(u, vp1, vs1, rho1, vp2, vs2, rho2, cdtype):
    """P-SV R/T coefficient matrices for a welded interface.

    Port of ``coeffm`` (greens.cpp:19-85): table-1 (downgoing incident,
    medium 1) and table-2 (upgoing incident, medium 2) coefficients.
    Inputs broadcast elementwise; returns (rd, td, ru, tu) each
    (..., 2, 2) complex.
    """
    mue1 = rho1 * vs1 * vs1
    mue2 = rho2 * vs2 * vs2
    c = 2.0 * (mue1 - mue2)
    u2 = u * u
    cu2 = c * u2
    a1 = _csqrt_conj(1.0 / (vp1 * vp1) - u2, cdtype)
    a2 = _csqrt_conj(1.0 / (vp2 * vp2) - u2, cdtype)
    b1 = _csqrt_conj(1.0 / (vs1 * vs1) - u2, cdtype)
    b2 = _csqrt_conj(1.0 / (vs2 * vs2) - u2, cdtype)

    t1 = cu2 - rho1 + rho2
    t2 = cu2 - rho1
    t3 = cu2 + rho2
    t4 = t3 * a1 - t2 * a2

    # downgoing incident (table 1)
    d1 = t1 * t1 * u2 + t2 * t2 * a2 * b2 + rho1 * rho2 * a2 * b1
    d2 = c * c * u2 * a1 * a2 * b1 * b2 + t3 * t3 * a1 * b1 \
        + rho1 * rho2 * a1 * b2
    t5 = 1.0 / (d1 + d2)
    t7 = 2.0 * rho1 * t5

    rpp = (d2 - d1) * t5
    rps = -2.0 * u * a1 * t5 * (t1 * t3 + c * t2 * a2 * b2)
    tpp = a1 * t7 * (t3 * b1 - t2 * b2)
    tps = -a1 * t7 * u * (t1 + c * a2 * b1)
    rss = (d2 - d1 - 2.0 * rho1 * rho2 * (a1 * b2 - a2 * b1)) * t5
    rsp = 2.0 * u * b1 * t5 * (t1 * t3 + c * t2 * a2 * b2)
    tss = b1 * t7 * t4
    tsp = b1 * t7 * u * (t1 + c * a1 * b2)

    rd = _mat(rpp, rsp, rps, rss)
    td = _mat(tpp, tsp, tps, tss)

    # upgoing incident (table 2)
    d1 = t1 * t1 * u2 + t3 * t3 * a1 * b1 + rho1 * rho2 * a1 * b2
    d2 = c * c * u2 * a1 * a2 * b1 * b2 + t2 * t2 * a2 * b2 \
        + rho1 * rho2 * a2 * b1
    t5 = 1.0 / (d1 + d2)
    t7 = 2.0 * rho2 * t5

    rpp = (d2 - d1) * t5
    rps = 2.0 * u * a2 * t5 * (t1 * t2 + c * t3 * a1 * b1)
    tpp = a2 * t7 * (t3 * b1 - t2 * b2)
    tps = -a2 * t7 * u * (t1 + c * a1 * b2)
    rss = (d2 - d1 - 2.0 * rho1 * rho2 * (a2 * b1 - a1 * b2)) * t5
    rsp = -2.0 * u * b2 * t5 * (t1 * t2 + c * t3 * a1 * b1)
    tss = b2 * t7 * t4
    tsp = b2 * t7 * u * (t1 + c * a2 * b1)

    ru = _mat(rpp, rsp, rps, rss)
    tu = _mat(tpp, tsp, tps, tss)
    return rd, td, ru, tu


def interface_coefficients_sh(u, vs1, rho1, vs2, rho2, cdtype):
    """SH scalar R/T coefficients (greens.cpp:78-85)."""
    mue1 = rho1 * vs1 * vs1
    mue2 = rho2 * vs2 * vs2
    b1 = _csqrt_conj(1.0 / (vs1 * vs1) - u * u, cdtype)
    b2 = _csqrt_conj(1.0 / (vs2 * vs2) - u * u, cdtype)
    mb1 = mue1 * b1
    mb2 = mue2 * b2
    mmm = 1.0 / (mb1 + mb2)
    rhd = (mb1 - mb2) * mmm
    rhu = -rhd
    thd = 2.0 * mb1 * mmm
    thu = 2.0 * mb2 * mmm
    return rhd, thd, rhu, thu


def free_surface_reflection(u, vp, vs, cdtype):
    """Free-surface P-SV reflection matrix for upgoing waves.

    Port of ``coeffs`` (greens.cpp:87-112) — note the PLAIN complex
    sqrt branch here, unlike ``coeffm``.
    """
    u2 = u * u
    a = _csqrt_plain(1.0 / (vp * vp) - u2, cdtype)
    b = _csqrt_plain(1.0 / (vs * vs) - u2, cdtype)
    t1 = 2.0 * vs * vs
    t2 = t1 * u2 - 1.0
    d1 = t2 * t2
    d2 = t1 * t1 * u2 * a * b
    d = d1 + d2
    t3 = 2.0 * t1 * u * t2 / d
    rpp = (d2 - d1) / d
    rsp = -b * t3
    rps = a * t3
    rss = rpp
    return _mat(rpp, rsp, rps, rss)


def displacement_matrix(u, vp, vs, cdtype):
    """Free-surface displacement matrix h — Mueller eq. 89
    (greens.cpp:307-322)."""
    vp2 = vp * vp
    vs2 = vs * vs
    p2 = u * u
    x = 1.0 - 2.0 * vs2 * p2
    a1 = _csqrt_conj(1.0 / vp2 - p2, cdtype)
    b1 = _csqrt_conj(1.0 / vs2 - p2, cdtype)
    q = 1.0 / (x * x + 4.0 * vs2 * vs2 * p2 * a1 * b1)
    return _mat(q * a1 * b1 * 2.0 * vs2 * u,
                q * b1 * (1.0 - 2.0 * vs2 * p2),
                q * a1 * (1.0 - 2.0 * vs2 * p2),
                -q * a1 * b1 * 2.0 * vs2 * u)


# ----------------------------------------------------------------------
# earth flattening (rfmini variant)
# ----------------------------------------------------------------------

def flatten_model(h, vp, vs, rho):
    """rfmini earth-flattening transform (model.cpp:223-251).

    ``h`` is the (NL,) padded thickness vector (halfspace & padding 0).
    z→R·ln(R/(R−z)) at layer TOPS; v·R/r; ρ·r/R.  Returns flattened
    (h, vp, vs, rho).
    """
    z_top = jnp.concatenate([jnp.zeros_like(h[:1]), jnp.cumsum(h)[:-1]])
    z_bot = z_top + h
    q_top = EARTH_R / (EARTH_R - z_top)
    zf_top = EARTH_R * jnp.log(q_top)
    zf_bot = EARTH_R * jnp.log(EARTH_R / (EARTH_R - z_bot))
    h_f = zf_bot - zf_top
    vp_f = vp * q_top
    vs_f = vs * q_top
    rho_f = rho / q_top
    return h_f, vp_f, vs_f, rho_f


def rho_vp(vp):
    """Berteussen/Gardner density-velocity relation (model.cpp:150-165)."""
    return (0.77 + 0.32 * vp
            + 0.68 * jnp.exp(-0.12 * (vp - 1.8) ** 2)
            - 0.09 * (vp - 5.5) * jnp.exp(-0.7 * (vp - 5.5) ** 2))


# ----------------------------------------------------------------------
# transmission response + receiver function
# ----------------------------------------------------------------------

def _transmission_response(h, vp, vs, rho, qp, qs, slowness, nsamp, fsamp,
                           wave_type, fref, cdtype, options=0):
    """Per-frequency (cz, cr) transmission responses of the flattened
    stack — port of ``calcresp_core`` (greens.cpp:400-683) without the
    partial-derivative branches.  Frequency axis fully vectorized.
    ``options`` is a static bitmask of SUPPRESS_MULTIPLES /
    WITHOUT_ANELASTICITY (synrf.h:52-53; see the flag notes at the
    top of this module).
    """
    nl = h.shape[-1]
    nfreq = nsamp // 2 + 1
    p = slowness
    p2 = p * p
    rdtype = h.dtype

    # interface coefficients: slot 0 = free surface, slot i = top of
    # layer i (between layers i-1 and i), computed once (real vels).
    ru0 = free_surface_reflection(p, vp[0], vs[0], cdtype)
    rd_i, td_i, ru_i, tu_i = interface_coefficients(
        p, vp[:-1], vs[:-1], rho[:-1], vp[1:], vs[1:], rho[1:], cdtype)
    zero22 = jnp.zeros((1, 2, 2), cdtype)
    ru = jnp.concatenate([ru0[None], ru_i], axis=0)       # (NL, 2, 2)
    rd = jnp.concatenate([zero22, rd_i], axis=0)
    td = jnp.concatenate([zero22, td_i], axis=0)
    tu = jnp.concatenate([zero22, tu_i], axis=0)

    # free-surface displacement matrix (layer-1 properties)
    hmat = displacement_matrix(p, vp[0], vs[0], cdtype)   # (2, 2)

    # direct-wave travel time t0 (greens.cpp:509-526); the halfspace
    # enters with its h = -1 sentinel (model.cpp:12-20, synrf.cpp:31).
    v_dir = vp if wave_type == P_WAVE else vs
    q_vert = _sqrt_relu(1.0 / (v_dir * v_dir) - p2)
    h_t0 = h.at[-1].set(-1.0)
    t0 = jnp.sum(h_t0 * q_vert)

    # frequency axis
    j = jnp.arange(nfreq, dtype=rdtype)
    dw = 2.0 * jnp.pi * fsamp / nsamp
    w = dw * j                                            # (F,)
    wref = 2.0 * jnp.pi * fref
    lgw = jnp.where(j > 0, jnp.log(jnp.maximum(w, 1e-30) / wref), 0.0)

    # complex anelastic velocities & phase matrices, Mueller eq. 132
    # (greens.cpp:536-548): e[i] = diag(exp(-iwd*q_p), exp(-iwd*q_s))
    ii = jnp.asarray(1j, cdtype)
    if options & WITHOUT_ANELASTICITY:
        # elastic phase matrices: real velocities (Q -> inf), still
        # complex vertical slowness for evanescent waves
        vpc = jnp.broadcast_to(vp[None, :].astype(cdtype),
                               (nfreq, nl))
        vsc = jnp.broadcast_to(vs[None, :].astype(cdtype),
                               (nfreq, nl))
    else:
        vpc = vp[None, :] * (1.0 + lgw[:, None] / (jnp.pi * qp[None, :])
                             + ii / (2.0 * qp[None, :]))
        vsc = vs[None, :] * (1.0 + lgw[:, None] / (jnp.pi * qs[None, :])
                             + ii / (2.0 * qs[None, :]))
    plc = jnp.sqrt(1.0 / (vpc * vpc) - p2)                # (F, NL)
    slc = jnp.sqrt(1.0 / (vsc * vsc) - p2)
    miwd = -ii * (w[:, None] * h[None, :]).astype(cdtype)
    e11 = jnp.exp(miwd * plc)
    e22 = jnp.exp(miwd * slc)
    e_diag = jnp.stack([e11, e22], axis=-1)               # (F, NL, 2)

    # top-down recursion (greens.cpp:196-224), scanning layers 0..NL-2;
    # all (F,)-vectors at once.  2x2 complex matrices are carried as
    # explicit component 4-tuples: unrolled component algebra fuses
    # into elementwise kernels, where tiny (2,2) matmuls would each
    # become a separate batched dot.
    def as4(m):  # (..., 2, 2) -> component tuple
        return (m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1])

    def mul4(A, B):
        a11, a12, a21, a22 = A
        b11, b12, b21, b22 = B
        return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
                a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)

    one_f = jnp.ones((nfreq,), cdtype)
    zero_f = jnp.zeros((nfreq,), cdtype)
    eye4 = (one_f, zero_f, zero_f, one_f)

    def step(carry, xs):
        nb_prev, qc, g = carry
        ru_m, rd_n, tu_n, td_m, e_m, first = xs
        ru4, rd4 = as4(ru_m), as4(rd_n)
        tu4, td4 = as4(tu_n), as4(td_m)

        # nt = ru + td @ nb_prev @ qc (first layer: just ru)
        t11, t12, t21, t22 = mul4(mul4(td4, nb_prev), qc)
        nt = (jnp.where(first, ru4[0], ru4[0] + t11),
              jnp.where(first, ru4[1], ru4[1] + t12),
              jnp.where(first, ru4[2], ru4[2] + t21),
              jnp.where(first, ru4[3], ru4[3] + t22))

        # nb = e @ nt @ e for diagonal phase e (greens.cpp:829-845)
        e1, e2 = e_m[..., 0], e_m[..., 1]
        e12 = e1 * e2
        nb = (nt[0] * e1 * e1, nt[1] * e12, nt[2] * e12,
              nt[3] * e2 * e2)

        # q_new = inv(I - rd @ nb) @ tu
        m11, m12, m21, m22 = mul4(rd4, nb)
        k11, k12, k21, k22 = 1.0 - m11, -m12, -m21, 1.0 - m22
        det = k11 * k22 - k12 * k21
        inv = (k22 / det, -k12 / det, -k21 / det, k11 / det)
        q_new = mul4(inv, tu4)

        # g_new = g @ (e * q_new) (first layer: e * q_new)
        eq = (e1 * q_new[0], e1 * q_new[1],
              e2 * q_new[2], e2 * q_new[3])
        gq = mul4(g, eq)
        g_new = (jnp.where(first, eq[0], gq[0]),
                 jnp.where(first, eq[1], gq[1]),
                 jnp.where(first, eq[2], gq[2]),
                 jnp.where(first, eq[3], gq[3]))
        return (nb, q_new, g_new), None

    def step_suppress(g, xs):
        """SUPPRESS_MULTIPLES recursion (greens.cpp:212-216 with
        default-zero nb): nt collapses to 0, q = tu, so
        g = prod_i e_i tu_{i+1} — the pure direct downward
        transmission with no reverberations."""
        _, _, tu_n, _, e_m, first = xs
        tu4 = as4(tu_n)
        e1, e2 = e_m[..., 0], e_m[..., 1]
        eq = (e1 * tu4[0], e1 * tu4[1], e2 * tu4[2], e2 * tu4[3])
        gq = mul4(g, eq)
        g_new = tuple(jnp.where(first, eq[k], gq[k])
                      for k in range(4))
        return g_new, None

    xs = (ru[:-1], rd[1:], tu[1:], td[:-1],
          jnp.moveaxis(e_diag, 1, 0)[:-1],
          jnp.arange(nl - 1) == 0)
    if options & SUPPRESS_MULTIPLES:
        g, _ = lax.scan(step_suppress, eye4, xs)
    else:
        (_, _, g), _ = lax.scan(step, (eye4, eye4, eye4), xs)

    # t_resp = 2 * hmat @ g, then pick the incident-wave column
    h4 = as4(hmat)
    t11 = 2.0 * (h4[0] * g[0] + h4[1] * g[2])
    t12 = 2.0 * (h4[0] * g[1] + h4[1] * g[3])
    t21 = 2.0 * (h4[2] * g[0] + h4[3] * g[2])
    t22 = 2.0 * (h4[2] * g[1] + h4[3] * g[3])
    if wave_type == P_WAVE:
        cr = t11
        cz = t21
    else:  # SV
        cr = t12
        cz = t22

    qq = jnp.exp(ii * (w * t0).astype(cdtype))
    return cz * qq, cr * qq


def _decompose_zr(cz, cr, p, vp0, vs0):
    """Z/R → P/SV wavefield decomposition (greens.cpp:324-341)."""
    fa = 1.0 / (vp0 * vp0) - p * p
    fb = 1.0 / (vs0 * vs0) - p * p
    a = jnp.sqrt(jnp.where(fa > 1e-30, fa, 1e-30))
    b = jnp.sqrt(jnp.where(fb > 1e-30, fb, 1e-30))
    m11 = -(2.0 * vs0 * vs0 * p * p - 1.0) / (vp0 * a)
    m12 = 2.0 * p * vs0 * vs0 / vp0
    m21 = -2.0 * p * vs0
    m22 = (1.0 - 2.0 * vs0 * vs0 * p * p) / (vs0 * b)
    cz_n = cz * m11 + cr * m12
    cr_n = cz * m21 + cr * m22
    return cz_n, cr_n


def _deconvolve(cz, cr, wave_type, nsamp, fsamp, tshift, gauss_a, p,
                vp_top, vs_top, cdtype, apply_cq=True):
    """Spectral division + Gauss filter + time shift — port of
    ``compute_rf`` (greens.cpp:343-398).  The waterlevel is NOT applied
    (dead code in the reference).  ``apply_cq=False`` skips the
    Gauss/shift multiply (the caller folds it elsewhere); the cr/cz
    outputs are then raw."""
    nfreq = cz.shape[-1]
    rdtype = jnp.real(cz).dtype

    do_decomp = (vs_top > 0.01) & (jnp.abs(p) > 0.0001)
    cz_d, cr_d = _decompose_zr(cz, cr, p, vp_top, vs_top)
    cz = jnp.where(do_decomp, cz_d, cz)
    cr = jnp.where(do_decomp, cr_d, cr)

    if wave_type == SV_WAVE:
        cz, cr = cr, cz  # deconvolve P with SV (greens.cpp:369-373)

    denom = jnp.real(cz * jnp.conj(cz))
    crf = cr * jnp.conj(cz) / denom

    if not apply_cq:
        return crf, cr, cz
    # traced (fsamp/tshift/gauss_a may be tracers under synrf's jit)
    dw = 2.0 * jnp.pi * fsamp / nsamp
    w = dw * jnp.arange(nfreq, dtype=rdtype)
    qfac = jnp.sqrt(jnp.pi) * fsamp / gauss_a
    wa = jnp.minimum(w / gauss_a, 50.0)
    ii = jnp.asarray(1j, cdtype)
    cq = qfac * jnp.exp((-0.25 * wa * wa).astype(cdtype)
                        - ii * (w * tshift).astype(cdtype))
    return crf * cq, cr * cq, cz * cq


@partial(jax.jit,
         static_argnames=('nsamp', 'wave_type', 'flattening',
                          'options'))
def synrf(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp, fsamp, tshift,
          nsv, poisson, wave_type=P_WAVE, fref=1.0, flattening=True,
          options=0):
    """Synthetic receiver function + Z/R responses for one padded model.

    Mirrors the reference entry points ``rfmini.synrf``
    (rfmini.pyx:74-114) → ``synrf_cwrap`` (wrap.cpp:57-80) →
    ``synrf`` (synrf.cpp:16-55):

      h, vp, vs, rho : (NL,) padded layer arrays (halfspace last,
                       zero-thickness padding; spherical/unflattened)
      qp, qs         : (NL,) quality factors
      p_sdeg         : slowness in s/deg (converted with 0.00899)
      gauss_a        : Gauss low-pass parameter a
      nsamp, fsamp   : FFT length (power of 2) and sampling rate
      tshift         : left time shift of the RF
      nsv, poisson   : near-surface S velocity and Poisson ratio for
                       the surface rotation (wrap.cpp:73-74)
      wave_type      : P_WAVE (0) or SV_WAVE (1)
      options        : static bitmask of SUPPRESS_MULTIPLES /
                       WITHOUT_ANELASTICITY (synrf.h:52-53; module
                       flag notes)

    Returns (fz, fr, rf) each (nsamp,) real time series.
    Batch with jax.vmap over a leading model axis.
    """
    rdtype = h.dtype
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64
    slowness = (p_sdeg * DEG_PER_KM).astype(rdtype)
    vp_top = nsv * jnp.sqrt((1.0 - poisson) / (0.5 - poisson))
    vs_top = nsv

    if flattening:
        h_f, vp_f, vs_f, rho_f = flatten_model(h, vp, vs, rho)
    else:
        h_f, vp_f, vs_f, rho_f = h, vp, vs, rho

    cz, cr = _transmission_response(
        h_f, vp_f, vs_f, rho_f, qp, qs, slowness, nsamp, fsamp,
        wave_type, fref, cdtype, options=options)

    crf, crq, czq = _deconvolve(
        cz, cr, wave_type, nsamp, fsamp, tshift, gauss_a, slowness,
        vp_top, vs_top, cdtype)

    rf = jnp.fft.irfft(crf, nsamp).astype(rdtype)
    fr = jnp.fft.irfft(crq, nsamp).astype(rdtype)
    fz = jnp.fft.irfft(czq, nsamp).astype(rdtype)
    return fz, fr, rf
