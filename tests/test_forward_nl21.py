"""The production forward solvers in float32 at the production model
width (nl = 21: the tutorial model padded with zero-thickness copies of
the halfspace) against the native C++ goldens in float64.

This is the CPU side of chip_smoke.py's forward phase: the same
solvers, dtype and width, so a change that breaks float32 parity shows
here before it reaches the GPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bayhunter_jax import native
from bayhunter_jax.ops.rf import synrf, P_WAVE, SV_WAVE
from bayhunter_jax.ops.swd import surfdisp

NL = 21
H = np.array([5., 23., 8., 0.])
VS = np.array([2.7, 3.6, 3.8, 4.4])
VP = VS * 1.73
RHO = VP * 0.32 + 0.77
# mode 1 over the tutorial band; mode 2 exists only below ~10 s here
PERIODS = {1: np.linspace(1.0, 41.0, 21), 2: np.linspace(1.0, 10.0, 10)}
# km/s; the group velocity differences two phase solves at t/(1+-h)
TOL = {0: 1e-4, 1: 5e-4}


@pytest.fixture(autouse=True)
def _native_library():
    if native.load() is None:  # pragma: no cover
        pytest.skip('native library unavailable')


def padded(x, fill):
    return jnp.asarray(np.concatenate([x, np.full(NL - x.size, fill)]),
                       jnp.float32)


@pytest.mark.parametrize('sph', [0, 1], ids=['flat', 'spherical'])
@pytest.mark.parametrize('mode', [1, 2])
@pytest.mark.parametrize('igr', [0, 1], ids=['phase', 'group'])
@pytest.mark.parametrize('iwave', [2, 1], ids=['rayleigh', 'love'])
def test_dispersion_f32_nl21_vs_native(iwave, igr, mode, sph):
    per = PERIODS[mode]
    gold, gerr = native.surfdisp_native(H, VP, VS, RHO, per,
                                        iwave=iwave, mode=mode, igr=igr,
                                        iflsph=sph)
    cg, err = surfdisp(padded(H, 0.0), padded(VP, VP[-1]),
                       padded(VS, VS[-1]), padded(RHO, RHO[-1]),
                       jnp.asarray(per, jnp.float32), iwave=iwave,
                       mode=mode, igr=igr, iflsph=sph)
    assert not gerr and not bool(err)
    assert np.asarray(cg).dtype == np.float32
    np.testing.assert_allclose(np.asarray(cg, np.float64), gold,
                               atol=TOL[igr])


@pytest.mark.parametrize('wave', [P_WAVE, SV_WAVE], ids=['prf', 'srf'])
def test_rf_f32_nl21_vs_native(wave):
    nsamp, fsamp, tshift, gauss, p = 512, 5.0, 5.0, 1.0, 6.4
    poisson = (2 - 1.73 ** 2) / (2 - 2 * 1.73 ** 2)
    _, _, gold = native.synrf_native(
        H, VP, VS, RHO, np.full(4, 500.0), np.full(4, 225.0), p, gauss,
        nsamp, fsamp, tshift, VS[0], poisson, wave_type=wave)
    _, _, rf = synrf(padded(H, 0.0), padded(VP, VP[-1]),
                     padded(VS, VS[-1]), padded(RHO, RHO[-1]),
                     jnp.full(NL, 500.0, jnp.float32),
                     jnp.full(NL, 225.0, jnp.float32), p, gauss, nsamp,
                     fsamp, tshift, float(VS[0]), poisson,
                     wave_type=wave)
    rf = np.asarray(rf, np.float64)[:201]
    assert np.all(np.isfinite(rf))
    np.testing.assert_allclose(rf, gold[:201], atol=1e-4)
