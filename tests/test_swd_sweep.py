"""Randomized dispersion stress sweep against the independent native
C++ golden: the reference's hardest failure modes live in the root
search (mode jumps near osculating modes, LVZ reverse dispersion,
getsol misses — reference: extensions/surfdisp96.f:313-327,429-447),
so the JAX solver and the native transcription must agree on BOTH the
error flag and the located root for hundreds of pathological models —
a silent mode-jump in either implementation shows up as a gross value
mismatch with no error flag.

Calibration (1000 cases): zero flag mismatches, zero value
disagreements > 5e-4; f32 secant-polish error vs f64: median 1.7e-7,
p99 1.2e-6, max 1.6e-4 — all inside the dc/16 bracket-width worst
case (~3.1e-4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bayhunter_jax import native
from bayhunter_jax.ops.swd import surfdisp


@pytest.fixture(autouse=True)
def _native_library():
    if native.load() is None:  # pragma: no cover
        pytest.skip('native library unavailable')


NL = 10
PERIODS = np.linspace(2.0, 35.0, 11)        # fundamental-mode band
PERIODS_HI = np.linspace(0.6, 4.0, 9)       # higher modes need short T
KINDS = ('plain', 'lvz', 'hvz', 'thin', 'vpvs')
N_PER_KIND = 20


def _pad(arr, hs):
    out = np.full(NL, hs)
    out[:arr.size] = arr
    return out


def make_model(rs, kind):
    """Random layered model of a pathology class: low-velocity zone,
    high-velocity zone (reverse dispersion territory), thin layers,
    high vp/vs — the regimes where root searches mode-jump."""
    nlay = rs.randint(3, 7)
    vs = np.sort(rs.uniform(2.2, 4.6, nlay))
    h = rs.uniform(3.0, 15.0, nlay)
    vpvs = 1.73
    if kind == 'lvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = vs[i - 1] * rs.uniform(0.75, 0.95)
    elif kind == 'hvz':
        i = rs.randint(1, nlay - 1)
        vs[i] = min(vs[i + 1] * rs.uniform(1.05, 1.25), 4.8)
    elif kind == 'thin':
        h[rs.randint(0, nlay - 1)] = rs.uniform(0.3, 1.5)
    elif kind == 'vpvs':
        vpvs = rs.uniform(1.9, 2.1)
    h[-1] = 0.0
    vp = vs * vpvs
    rho = vp * 0.32 + 0.77
    return h, vp, vs, rho


def _jax_case(h, vp, vs, rho, periods, iwave, mode, igr, dtype):
    cg, err = surfdisp(jnp.asarray(_pad(h, 0.0), dtype),
                       jnp.asarray(_pad(vp, vp[-1]), dtype),
                       jnp.asarray(_pad(vs, vs[-1]), dtype),
                       jnp.asarray(_pad(rho, rho[-1]), dtype),
                       jnp.asarray(periods, dtype),
                       iwave=iwave, mode=mode, igr=igr)
    return np.asarray(cg), bool(err)


def _sweep(combos, periods, min_found):
    rs = np.random.RandomState(42)
    n_found = 0
    for kind in KINDS:
        for i in range(N_PER_KIND):
            h, vp, vs, rho = make_model(rs, kind)
            for iwave, mode, igr in combos:
                cg_n, err_n = native.surfdisp_native(
                    h, vp, vs, rho, periods, iwave=iwave, mode=mode,
                    igr=igr)
                cg_j, err_j = _jax_case(h, vp, vs, rho, periods,
                                        iwave, mode, igr, jnp.float64)
                case = '%s[%d] iwave=%d mode=%d igr=%d' \
                    % (kind, i, iwave, mode, igr)
                assert err_j == err_n, 'flag mismatch: ' + case
                if not err_n:
                    n_found += 1
                    d = np.max(np.abs(cg_j - cg_n))
                    assert d < 5e-4, \
                        'root mismatch %.2e (mode jump?): %s' % (d,
                                                                 case)
    # the sweep must exercise real solves, not just consistent errs
    assert n_found >= min_found, n_found


def test_sweep_fundamental_modes():
    """500 cases: Rayleigh/Love phase + Rayleigh group, fundamental
    mode, across all five pathology classes."""
    _sweep([(2, 1, 0), (1, 1, 0), (2, 1, 1), (1, 1, 1),
            (2, 1, 0)], PERIODS, min_found=350)


def test_sweep_higher_modes():
    """Modes 2-3 at short periods (above their cutoff): found roots
    must agree with the native golden; cutoffs must flag identically
    (no silent fundamental-mode fallback)."""
    _sweep([(2, 2, 0), (1, 2, 0), (2, 3, 0)], PERIODS_HI,
           min_found=50)


def test_f32_refinement_error_bounded():
    """Regression bound on the f32 solver's root accuracy: the default single sign pass + secant polish must stay
    well inside the dc/16 bracket width against the f64 native golden
    — in distribution, not just on parity fixtures."""
    rs = np.random.RandomState(7)
    errs = []
    for kind in KINDS:
        for _ in range(12):
            h, vp, vs, rho = make_model(rs, kind)
            cg_n, err_n = native.surfdisp_native(h, vp, vs, rho,
                                                 PERIODS, iwave=2)
            if err_n:
                continue
            cg32, err32 = _jax_case(h, vp, vs, rho, PERIODS, 2, 1, 0,
                                    jnp.float32)
            assert not err32
            errs.append(np.abs(cg32 - cg_n))
    e = np.concatenate(errs)
    assert e.size >= 400
    # calibrated: median 1.7e-7 p99 1.2e-6 max 1.6e-4 (2200 lanes)
    assert np.median(e) < 2e-6
    assert np.percentile(e, 99) < 2e-5
    assert e.max() < 3.3e-4  # dc/16 bracket width is the hard ceiling


def test_walker_warm_refinement_error_bounded():
    """Regression bound on the WARM solver's root accuracy (the ring
    search around the cached roots that every model move runs):
    randomized vs-move-sized perturbations of pathology models,
    warm-solved in f32 from the unperturbed model's roots at the
    vs-move ring width, against the f64 native golden of the perturbed
    model.  The closing secant polish on the bracket values carries
    the accuracy; rare warm-vs-cold root-selection differences near
    osculating modes are bounded as a count, not a magnitude."""
    import jax
    from bayhunter_jax.ops.swd import surfdisp_roots

    rs = np.random.RandomState(17)
    per = jnp.asarray(PERIODS, jnp.float32)
    cold = jax.jit(jax.vmap(lambda h, a, b, r: surfdisp_roots(
        h, a, b, r, per)))
    warm = jax.jit(jax.vmap(lambda h, a, b, r, c: surfdisp_roots(
        h, a, b, r, per, c_prev=c, warm_halfwidth=16)))
    errs = []
    n_outlier = 0
    for kind in KINDS:
        rows0, rows2, golds = [], [], []
        while len(rows0) < 6:
            h, vp, vs, rho = make_model(rs, kind)
            vs2 = vs.copy()
            i = rs.randint(0, vs.size)
            vs2[i] = np.clip(vs2[i] + rs.normal(0, 0.015), 2.0, 5.0)
            vp2 = vs2 * (vp[0] / vs[0])
            rho2 = vp2 * 0.32 + 0.77
            cg_n, err_n = native.surfdisp_native(h, vp2, vs2, rho2,
                                                 PERIODS, iwave=2)
            if err_n:
                continue
            rows0.append((_pad(h, 0.0), _pad(vp, vp[-1]),
                          _pad(vs, vs[-1]), _pad(rho, rho[-1])))
            rows2.append((_pad(h, 0.0), _pad(vp2, vp2[-1]),
                          _pad(vs2, vs2[-1]), _pad(rho2, rho2[-1])))
            golds.append(cg_n)
        B = lambda rows, j: jnp.asarray(
            np.stack([r[j] for r in rows]).astype(np.float32))
        args0 = tuple(B(rows0, j) for j in range(4))
        args2 = tuple(B(rows2, j) for j in range(4))
        gold = np.stack(golds)
        _, _, roots = cold(*args0)
        cg, err, _ = warm(*args2, roots)
        cgv = np.asarray(cg)
        found = np.isfinite(cgv) & (cgv > 0)
        e = np.abs(cgv[found] - gold[found])
        n_outlier += int((e > 1.5e-3).sum())
        errs.append(e[e <= 1.5e-3])
    e = np.concatenate(errs)
    # calibrated on the CPU (330 lanes): median 1.5e-7, p99 7.6e-7,
    # max 9.5e-5, no outliers
    assert e.size >= 250
    assert np.median(e) < 2e-6
    assert np.percentile(e, 99) < 2e-5
    assert n_outlier <= 0.01 * (e.size + n_outlier)
