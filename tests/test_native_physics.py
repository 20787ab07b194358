"""Independent physics property tests for the forward-solver cores.

The C++ goldens (native/{dispersion,reflectivity}.cc) are deliberate
transliterations of the reference's factoring (SURVEY.md §7), so
golden parity cannot catch a bug *inherited* from the reference
(surfdisp96.f / greens.cpp).  These tests check conservation laws and
closed-form anchors that share NO factoring with either
implementation:

* energy-flux balance of the interface R/T matrices (lossless welded
  interface, pre-critical incidence: reflected + transmitted vertical
  energy flux equals the incident flux, per wave type and direction);
* total reflection at the free surface;
* zero P<->SV mode conversion at normal incidence;
* the halfspace Rayleigh phase velocity against an independent
  numpy.roots solve of the Rayleigh cubic
  xi^3 - 8 xi^2 + 8 xi (3 - 2 gamma) - 16 (1 - gamma) = 0,
  xi = (c/vs)^2, gamma = (vs/vp)^2.

They drive the JAX coefficient functions (ops/rf.py, ops/swd.py);
the C++ goldens are pinned bit-tight against these same functions in
test_native.py, so a conservation failure in either implementation
surfaces here.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bayhunter_jax.ops.rf import coeff, coeffs
from bayhunter_jax.ops.swd import surfdisp


def _vertical_slownesses(u, vp, vs):
    return np.sqrt(1.0 / vp**2 - u**2), np.sqrt(1.0 / vs**2 - u**2)


def _random_interface(rs):
    vp1 = 6.0 + rs.rand()
    vs1 = 3.4 + 0.3 * rs.rand()
    rh1 = 2.7 + 0.2 * rs.rand()
    vp2 = 7.5 + rs.rand()
    vs2 = 4.3 + 0.3 * rs.rand()
    rh2 = 3.2 + 0.2 * rs.rand()
    # pre-critical for every scattered wave type in both media
    u = rs.uniform(0.01, 0.9 / max(vp1, vp2))
    return u, vp1, vs1, rh1, vp2, vs2, rh2


@pytest.mark.parametrize('dis', [0, 1])
def test_interface_flux_balance(dis):
    """|R|^2 + |T|^2 energy-flux balance at a welded interface, all
    four P-SV incidences (P/SV x down/up) plus SH both directions.
    Vertical energy flux of a propagating plane wave is
    rho * v^2 * q * |A|^2 for displacement amplitude A (dis=1) and
    rho * q * |phi|^2 for potential amplitude phi (dis=0), with
    q = sqrt(1/v^2 - u^2) the vertical slowness.  The coefficient
    matrices are [outgoing, incident] ordered (P=0, SV=1)."""
    rs = np.random.RandomState(42)
    for _ in range(20):
        u, vp1, vs1, rh1, vp2, vs2, rh2 = _random_interface(rs)
        qp1, qs1 = _vertical_slownesses(u, vp1, vs1)
        qp2, qs2 = _vertical_slownesses(u, vp2, vs2)
        rd, td, ru, tu, sh = coeff(u, vp1, vs1, rh1, vp2, vs2, rh2,
                                   dis=dis)
        rd = np.array(rd).reshape(2, 2)
        td = np.array(td).reshape(2, 2)
        ru = np.array(ru).reshape(2, 2)
        tu = np.array(tu).reshape(2, 2)

        def w(rho, v, q):
            return rho * v * v * q if dis else rho * q

        wp1, ws1 = w(rh1, vp1, qp1), w(rh1, vs1, qs1)
        wp2, ws2 = w(rh2, vp2, qp2), w(rh2, vs2, qs2)
        # downgoing incidence: scatter into rd (medium 1) + td (2)
        for inc, winc in ((0, wp1), (1, ws1)):
            bal = (abs(rd[0, inc])**2 * wp1 + abs(rd[1, inc])**2 * ws1
                   + abs(td[0, inc])**2 * wp2
                   + abs(td[1, inc])**2 * ws2)
            np.testing.assert_allclose(bal, winc, rtol=1e-10)
        # upgoing incidence (medium 2): ru (medium 2) + tu (medium 1)
        for inc, winc in ((0, wp2), (1, ws2)):
            bal = (abs(ru[0, inc])**2 * wp2 + abs(ru[1, inc])**2 * ws2
                   + abs(tu[0, inc])**2 * wp1
                   + abs(tu[1, inc])**2 * ws1)
            np.testing.assert_allclose(bal, winc, rtol=1e-10)
        # SH (always displacement-convention): weight rho * vs^2 * qs
        rhd, thd, rhu, thu = sh
        wsh1, wsh2 = rh1 * vs1**2 * qs1, rh2 * vs2**2 * qs2
        np.testing.assert_allclose(
            abs(rhd)**2 * wsh1 + abs(thd)**2 * wsh2, wsh1, rtol=1e-10)
        np.testing.assert_allclose(
            abs(rhu)**2 * wsh2 + abs(thu)**2 * wsh1, wsh2, rtol=1e-10)


def test_free_surface_total_reflection():
    """The free surface transmits nothing: reflected P + SV energy
    flux equals the incident flux for both incidences.  coeffs()
    returns the POTENTIAL-convention matrix (plain-sqrt branch), so
    the flux weight is the vertical slowness q alone."""
    rs = np.random.RandomState(7)
    for _ in range(20):
        vp = 6.0 + rs.rand()
        vs = 3.4 + 0.3 * rs.rand()
        u = rs.uniform(0.01, 0.9 / vp)
        qp, qs = _vertical_slownesses(u, vp, vs)
        (r11, r12, r21, r22), rhu = coeffs(u, vp, vs)
        np.testing.assert_allclose(
            abs(r11)**2 * qp + abs(r21)**2 * qs, qp, rtol=1e-10)
        np.testing.assert_allclose(
            abs(r12)**2 * qp + abs(r22)**2 * qs, qs, rtol=1e-10)
        assert rhu == 1.0  # total SH reflection


def test_no_mode_conversion_at_normal_incidence():
    """At u=0 the P-SV system decouples: every off-diagonal
    (converted) coefficient must vanish exactly, at the interface and
    at the free surface."""
    rd, td, ru, tu, _ = coeff(0.0, 6.0, 3.46, 2.7, 8.0, 4.6, 3.3,
                              dis=1)
    for m in (rd, td, ru, tu):
        m = np.array(m).reshape(2, 2)
        assert abs(m[0, 1]) == 0.0 and abs(m[1, 0]) == 0.0
    (r11, r12, r21, r22), _ = coeffs(0.0, 6.0, 3.46)
    assert abs(r12) == 0.0 and abs(r21) == 0.0


def test_halfspace_rayleigh_velocity_vs_cubic():
    """The halfspace Rayleigh phase velocity from the full secular
    machinery must match the classical Rayleigh cubic solved with
    numpy.roots — an anchor that shares nothing with the
    Dunkin/Haskell recursion.  Dispersion-free: identical at every
    period."""
    for vs_h, vpvs in ((4.4, 1.73), (3.2, 1.8), (2.5, 1.65)):
        vp_h = vs_h * vpvs
        gam = (vs_h / vp_h)**2
        roots = np.roots([1.0, -8.0, 8.0 * (3.0 - 2.0 * gam),
                          -16.0 * (1.0 - gam)])
        xi = min(r.real for r in roots
                 if abs(r.imag) < 1e-12 and 0.0 < r.real < 1.0)
        c_cubic = vs_h * np.sqrt(xi)

        h = jnp.asarray(np.array([0.0]))
        vs = jnp.asarray(np.array([vs_h]))
        vp = vs * vpvs
        rho = vp * 0.32 + 0.77
        c, err = surfdisp(h, vp, vs, rho,
                          periods=jnp.asarray(np.array([5., 12., 30.])),
                          iwave=2, igr=0)
        assert not bool(np.any(np.asarray(err)))
        np.testing.assert_allclose(np.asarray(c), c_cubic, atol=2e-4)


def test_love_needs_a_waveguide():
    """A pure halfspace supports no Love wave — the solver must
    signal err rather than fabricate a root."""
    h = jnp.asarray(np.array([0.0]))
    vs = jnp.asarray(np.array([4.0]))
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    _, err = surfdisp(h, vp, vs, rho,
                      periods=jnp.asarray(np.array([10.0])),
                      iwave=1, igr=0)
    assert bool(np.any(np.asarray(err)))
