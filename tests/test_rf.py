"""Golden and property tests for the RF reflectivity solver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bayhunter_jax.ops.rf import (synrf, flatten_model, rho_vp,
                                  interface_coefficients, P_WAVE, SV_WAVE)
from tests.conftest import golden_path

NL = 6
NSAMP, FSAMP, TSHFT = 512, 5.0, 5.0


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


def run_rf(args, wave, dtype=np.float64):
    qp = jnp.full(NL, 500., dtype)
    qs = jnp.full(NL, 225., dtype)
    vpvs0 = 1.73
    poisson = (2 - vpvs0 ** 2) / (2 - 2 * vpvs0 ** 2)
    return synrf(*args, qp, qs, 6.4, 1.0, NSAMP, FSAMP, TSHFT,
                 2.7, poisson, wave_type=wave)


@pytest.mark.parametrize('ref,wave', [('prf', P_WAVE), ('srf', SV_WAVE)])
def test_golden_rf(ref, wave):
    args = padded_tutorial()
    fz, fr, rf = run_rf(args, wave)
    gold = np.loadtxt(golden_path('st3_%s.dat' % ref))[:, 1]
    np.testing.assert_allclose(np.asarray(rf)[:201], gold, atol=2e-4)


def test_golden_rf_float32():
    args = padded_tutorial(np.float32)
    fz, fr, rf = run_rf(args, P_WAVE, np.float32)
    gold = np.loadtxt(golden_path('st3_prf.dat'))[:, 1]
    np.testing.assert_allclose(np.asarray(rf)[:201], gold, atol=5e-4)


def test_rf_direct_arrival_near_zero():
    """P receiver function: dominant direct arrival near t=0 (the
    reference golden trace peaks at t=0.8 s for this model)."""
    args = padded_tutorial()
    _, _, rf = run_rf(args, P_WAVE)
    rf = np.asarray(rf)[:201]
    t = np.linspace(-5, 35, 201)
    assert abs(t[np.argmax(np.abs(rf))]) <= 1.0


def test_padding_invariance():
    args6 = padded_tutorial()
    _, _, rf6 = run_rf(args6, P_WAVE)

    NL2 = 12
    h = np.zeros(NL2)
    h[:3] = [5., 23., 8.]
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77

    def pad(x):
        out = np.full(NL2, x[-1])
        out[:len(x)] = x
        return out

    args12 = tuple(jnp.asarray(v) for v in (h, pad(vp), pad(vs),
                                            pad(rho)))
    qp = jnp.full(NL2, 500.)
    qs = jnp.full(NL2, 225.)
    poisson = (2 - 1.73 ** 2) / (2 - 2 * 1.73 ** 2)
    _, _, rf12 = synrf(*args12, qp, qs, 6.4, 1.0, NSAMP, FSAMP, TSHFT,
                       2.7, poisson, wave_type=P_WAVE)
    np.testing.assert_allclose(np.asarray(rf6), np.asarray(rf12),
                               atol=1e-10)


def test_null_interface_coefficients():
    """Identical media: R = 0, T = identity."""
    rd, td, ru, tu = interface_coefficients(
        0.05, 6.0, 3.5, 2.7, 6.0, 3.5, 2.7, jnp.complex128)
    eye = np.eye(2)
    np.testing.assert_allclose(np.asarray(rd), 0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(ru), 0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(td), eye, atol=1e-14)
    np.testing.assert_allclose(np.asarray(tu), eye, atol=1e-14)


def test_energy_conservation_interface():
    """Sub-critical plane-wave R/T coefficients satisfy energy flux
    conservation for an incident P wave."""
    u = 0.05
    vp1, vs1, rho1 = 5.8, 3.2, 2.6
    vp2, vs2, rho2 = 8.0, 4.5, 3.3
    rd, td, ru, tu = interface_coefficients(
        u, vp1, vs1, rho1, vp2, vs2, rho2, jnp.complex128)
    a1 = np.sqrt(1 / vp1 ** 2 - u ** 2)
    b1 = np.sqrt(1 / vs1 ** 2 - u ** 2)
    a2 = np.sqrt(1 / vp2 ** 2 - u ** 2)
    b2 = np.sqrt(1 / vs2 ** 2 - u ** 2)
    rd = np.asarray(rd)
    td = np.asarray(td)
    # energy flux ratios (potential-normalized coefficients)
    e_rpp = np.abs(rd[0, 0]) ** 2
    e_rps = np.abs(rd[1, 0]) ** 2 * (rho1 * b1) / (rho1 * a1)
    e_tpp = np.abs(td[0, 0]) ** 2 * (rho2 * a2) / (rho1 * a1)
    e_tps = np.abs(td[1, 0]) ** 2 * (rho2 * b2) / (rho1 * a1)
    total = e_rpp + e_rps + e_tpp + e_tps
    np.testing.assert_allclose(total, 1.0, rtol=1e-8)


def test_flatten_model_roundtrip_props():
    h = jnp.asarray([5., 23., 8., 0., 0., 0.])
    vp = jnp.full(6, 6.0)
    vs = jnp.full(6, 3.5)
    rho = jnp.full(6, 2.7)
    hf, vpf, vsf, rhof = flatten_model(h, vp, vs, rho)
    # flattening stretches thickness and raises velocity with depth
    assert float(hf[1]) > 23.0
    assert float(vpf[1]) > 6.0
    assert float(rhof[1]) < 2.7
    # surface layer top unchanged
    np.testing.assert_allclose(float(vpf[0]), 6.0)


def test_rho_vp_crystalline():
    """At high vp the Berteussen term dominates (model.cpp:150-165)."""
    val = float(rho_vp(jnp.asarray(8.0)))
    assert abs(val - (0.77 + 0.32 * 8.0)) < 0.05


def test_vmap_batch():
    args = padded_tutorial()
    _, _, rf1 = run_rf(args, P_WAVE)
    batched = tuple(jnp.stack([a] * 4) for a in args)
    qp = jnp.full((4, NL), 500.)
    qs = jnp.full((4, NL), 225.)
    poisson = (2 - 1.73 ** 2) / (2 - 2 * 1.73 ** 2)
    fn = lambda h, vp, vs, rho, qpp, qss: synrf(
        h, vp, vs, rho, qpp, qss, 6.4, 1.0, NSAMP, FSAMP, TSHFT,
        2.7, poisson, wave_type=P_WAVE)
    fzb, frb, rfb = jax.vmap(fn)(*batched, qp, qs)
    np.testing.assert_allclose(np.asarray(rfb[2]), np.asarray(rf1),
                               atol=1e-12)


def test_coeff_introspection_normal_incidence():
    """rfmini-parity coeff()/coeffs() (reference: rfmini.pyx:252-331):
    at normal incidence the displacement reflection coefficients
    reduce to the classic impedance-contrast formulas and P/SV
    conversions vanish."""
    from bayhunter_jax.ops.rf import coeff, coeffs
    vp1, vs1, rh1 = 6.0, 3.5, 2.7
    vp2, vs2, rh2 = 8.0, 4.6, 3.3
    rd, td, ru, tu, sh = coeff(0.0, vp1, vs1, rh1, vp2, vs2, rh2,
                               dis=1)
    z1p, z2p = rh1 * vp1, rh2 * vp2
    z1s, z2s = rh1 * vs1, rh2 * vs2
    # downgoing P reflection: (Z2 - Z1)/(Z1 + Z2) in Mueller's sign
    # convention (medium 1 on top)
    np.testing.assert_allclose(rd[0].real, (z2p - z1p) / (z1p + z2p),
                               atol=1e-12)
    np.testing.assert_allclose(abs(rd[1]), 0.0, atol=1e-12)  # no P/SV
    np.testing.assert_allclose(abs(rd[2]), 0.0, atol=1e-12)
    # SH: rhd = (Z1s - Z2s)/(Z1s + Z2s), rhu = -rhd,
    # thd = 2 Z1s/(Z1s + Z2s)
    rhd, thd, rhu, thu = sh
    np.testing.assert_allclose(rhd.real, (z1s - z2s) / (z1s + z2s),
                               atol=1e-12)
    np.testing.assert_allclose(rhu.real, -rhd.real, atol=1e-12)
    np.testing.assert_allclose(thd.real, 2 * z1s / (z1s + z2s),
                               atol=1e-12)
    # energy-flux normalization of the displacement T/R pair (P at
    # normal incidence): R^2 + (Z2/Z1) T^2 = 1
    np.testing.assert_allclose(
        rd[0].real ** 2 + (z2p / z1p) * td[0].real ** 2, 1.0,
        atol=1e-12)

    # free surface: total reflection, |rpp| = 1 at normal incidence,
    # SH reflection exactly +1
    (ru11, ru12, ru21, ru22), rhu_s = coeffs(0.0, vp1, vs1)
    np.testing.assert_allclose(abs(ru11), 1.0, atol=1e-12)
    np.testing.assert_allclose(abs(ru12), 0.0, atol=1e-12)
    assert rhu_s == 1.0 + 0.0j


def test_synrf_solver_options():
    """The rfmini compile-time solver options (synrf.h:52-53) as
    runtime flags.  SUPPRESS_MULTIPLES must reduce the response to
    the pure direct downward transmission g = prod_i e_i tu_{i+1}
    (greens.cpp:212-216 with cmat2's default-zero nb);
    WITHOUT_ANELASTICITY must equal the Q -> inf limit of the
    anelastic law (Mueller eq. 132) and differ from finite Q."""
    import jax
    import jax.numpy as jnp
    from bayhunter_jax.ops.rf import (
        synrf, SUPPRESS_MULTIPLES, WITHOUT_ANELASTICITY,
        _transmission_response, interface_coefficients,
        flatten_model, DEG_PER_KM)

    NL = 6
    h = np.zeros(NL); h[:2] = [8.0, 20.0]
    vs = np.full(NL, 4.4); vs[:3] = [2.8, 3.6, 4.4]
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    qp = np.full(NL, 500.0); qs = np.full(NL, 225.0)
    args = [jnp.asarray(x) for x in (h, vp, vs, rho, qp, qs)]

    # --- WITHOUT_ANELASTICITY == Q -> inf limit ------------------
    rf_elastic = synrf(*args, 6.4, 1.0, 256, 5.0, 5.0, vs[0], 0.25,
                       options=WITHOUT_ANELASTICITY)[2]
    qbig = jnp.full(NL, 1e9)
    rf_qinf = synrf(args[0], args[1], args[2], args[3], qbig, qbig,
                    6.4, 1.0, 256, 5.0, 5.0, vs[0], 0.25)[2]
    np.testing.assert_allclose(np.asarray(rf_elastic),
                               np.asarray(rf_qinf), atol=1e-8)
    rf_anelastic = synrf(*args, 6.4, 1.0, 256, 5.0, 5.0, vs[0],
                         0.25)[2]
    assert np.max(np.abs(np.asarray(rf_elastic)
                         - np.asarray(rf_anelastic))) > 1e-4

    # --- SUPPRESS_MULTIPLES == direct transmission product -------
    slowness = jnp.asarray(6.4 * DEG_PER_KM, jnp.float64)
    hf, vpf, vsf, rhof = flatten_model(*args[:4])
    cz_s, cr_s = _transmission_response(
        hf, vpf, vsf, rhof, args[4], args[5], slowness, 256, 5.0,
        0, 1.0, jnp.complex128, options=SUPPRESS_MULTIPLES)

    # independent closed form: g = prod_i e_i tu_{i+1} with the same
    # public coefficient/phase building blocks
    nfreq = 256 // 2 + 1
    dw = 2.0 * np.pi * 5.0 / 256
    w = dw * np.arange(nfreq)
    lgw = np.where(np.arange(nfreq) > 0,
                   np.log(np.maximum(w, 1e-30) / (2 * np.pi)), 0.0)
    p = float(slowness)
    hf_n, vpf_n, vsf_n, rhof_n = (np.asarray(x) for x in
                                  (hf, vpf, vsf, rhof))
    g = np.broadcast_to(np.eye(2, dtype=complex), (nfreq, 2, 2)).copy()
    for i in range(NL - 1):
        vpc = vpf_n[i] * (1 + lgw / (np.pi * 500.0) + 1j / 1000.0)
        vsc = vsf_n[i] * (1 + lgw / (np.pi * 225.0) + 1j / 450.0)
        e1 = np.exp(-1j * w * hf_n[i]
                    * np.sqrt(1 / (vpc * vpc) - p * p))
        e2 = np.exp(-1j * w * hf_n[i]
                    * np.sqrt(1 / (vsc * vsc) - p * p))
        _, _, _, tu = interface_coefficients(
            p, vpf_n[i], vsf_n[i], rhof_n[i], vpf_n[i + 1],
            vsf_n[i + 1], rhof_n[i + 1], jnp.complex128)
        tu = np.asarray(tu)
        e = np.zeros((nfreq, 2, 2), complex)
        e[:, 0, 0], e[:, 1, 1] = e1, e2
        g = g @ (e @ np.broadcast_to(tu, (nfreq, 2, 2)))
    from bayhunter_jax.ops.rf import displacement_matrix
    hmat = np.asarray(displacement_matrix(p, vpf_n[0], vsf_n[0],
                                          jnp.complex128))
    t = 2.0 * np.einsum('ab,fbc->fac', hmat, g)
    qv = np.sqrt(np.maximum(1 / vpf_n ** 2 - p * p, 0.0))
    h_t0 = hf_n.copy(); h_t0[-1] = -1.0
    t0 = np.sum(h_t0 * qv)
    qq = np.exp(1j * w * t0)
    np.testing.assert_allclose(np.asarray(cz_s), t[:, 1, 0] * qq,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(cr_s), t[:, 0, 0] * qq,
                               rtol=1e-10, atol=1e-12)
