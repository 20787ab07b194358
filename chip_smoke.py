"""Smoke test of the joint SWD+RF inversion on an NVIDIA GPU.

Drives the system's main path through the entry points a user calls,
all in this one process (one JAX process per card):

  1. device      fail unless JAX runs on a GPU; print device_kind,
                 count and nvidia-smi's name and power limit
  2. forward     the plain f32 dispersion and receiver-function solvers
                 at nl = 21 (padded tutorial model) against the native
                 C++ goldens (f64, host); one case repeated in f64
  3. likelihood  the three correlated-noise laws at r = 0.98 over
                 10,240 rows against an f64 numpy evaluation
  4. main path   MCMC_Optimizer.mp_inversion at the tutorial
                 configuration, 21 chains, through the .npy/.pkl
                 output contract
  5. main path   the same at 10,240 chains
  6. tomography  TomoInversion at a small cell count

    python chip_smoke.py            # phases 1-6 on one GPU
    python chip_smoke.py --multi    # only the 4-GPU sharded path
                                    # (parallel tempering) and its
                                    # 1-GPU comparison

Every phase prints its numbers on a line of its own; the last line of
standard output is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase raises: the script then exits non-zero and prints no
result line.  Without a GPU it exits non-zero before any phase.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

NL = 21
PERIODS = np.linspace(1.0, 41.0, 21)
RF_ARGS = dict(p_sdeg=6.4, gauss_a=1.0, nsamp=512, fsamp=5.0,
               tshift=5.0)
RF_NDATA = 201
# tolerances against the f64 native goldens (km/s for dispersion; the
# group velocity is a finite difference of two phase solves at
# t/(1 +- 0.005), which amplifies the root error ~100x in principle —
# see tests/test_swd.py)
TOL_PHASE = 1e-4
TOL_GROUP = 5e-4
TOL_RF = 1e-4
# f64 on the card: both sides solve in double precision; the residual
# is the dispersion solver's root resolution (k-section + secant)
TOL_F64_PHASE = 1e-8
TOL_F64_RF = 1e-10
# likelihood: float32 on the card vs float64 numpy; the quadratic form
# is a sum of squares of whitened residuals (matrix product at
# Precision.HIGHEST — TF32 would miss this bound by ~100x)
LIKE_ROWS = 10240
LIKE_RTOL = 2e-5

ITERS_SMALL = 2000      # burn-in + main, 21 chains
ITERS_WIDE = 200        # burn-in + main, 10,240 chains
ITERS_TOMO = 400
ITERS_MULTI = 100
# cold chains of the --multi run: with ntemps = 2 that is 40,960 chain
# rows, 10,240 per card on four cards (the 10,240-chain width per card)
MULTI_CHAINS = 20480

STEP_MOVES = (('vs', 0), ('z', 1), ('birth', 2), ('death', 3),
              ('noise', 4), ('vpvs', 5))


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def result_line(platform, kind, count):
    """The contract's last line: exactly these keys."""
    return json.dumps({'ok': True, 'device': {
        'platform': platform, 'kind': kind, 'count': int(count)}})


# ---------------------------------------------------------------------
# compile-time accounting
# ---------------------------------------------------------------------

class CompileClock(object):
    """Sums XLA backend compile seconds reported through
    jax.monitoring (threads compiling concurrently each add their
    own, so the sum can exceed the wall time they overlapped)."""

    def __init__(self):
        import jax
        from jax._src import dispatch
        self.event = dispatch.BACKEND_COMPILE_EVENT
        self.secs = 0.0
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self)

    def __call__(self, event, duration, **kwargs):
        if event == self.event:
            self.secs += duration
            self.count += 1

    def mark(self):
        return self.secs, self.count


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get('peak_bytes_in_use')


# ---------------------------------------------------------------------
# phase 2: forward parity against the native goldens
# ---------------------------------------------------------------------

def tutorial_layers(nl=None):
    """The tutorial 4-layer truth model (reference tutorial/
    create_testdata.py): unpadded, and padded to ``nl`` slots with
    zero-thickness copies of the halfspace."""
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    vp = vs * 1.73
    rho = vp * 0.32 + 0.77
    if nl is None:
        return h, vp, vs, rho

    def pad(x, fill):
        return np.concatenate([x, np.full(nl - x.size, fill)])
    return pad(h, 0.0), pad(vp, vp[-1]), pad(vs, vs[-1]), \
        pad(rho, rho[-1])


def _rf_inputs(dtype, nl):
    import jax.numpy as jnp
    vpvs0 = 1.73
    poisson = (2 - vpvs0 ** 2) / (2 - 2 * vpvs0 ** 2)
    qp = np.full(nl, 500.0)
    qs = np.full(nl, 225.0)
    layers = [jnp.asarray(a, dtype) for a in tutorial_layers(nl)]
    return layers, jnp.asarray(qp, dtype), jnp.asarray(qs, dtype), \
        poisson


def forward_parity(f64=True):
    """Max |JAX - native golden| per case; raises beyond tolerance."""
    import jax
    import jax.numpy as jnp
    from bayhunter_jax import native
    from bayhunter_jax.ops.rf import synrf, P_WAVE
    from bayhunter_jax.ops.swd import surfdisp

    check(native.load() is not None, 'native golden library unavailable')
    h0, vp0, vs0, rho0 = tutorial_layers()
    out = {}

    def swd_case(name, iwave, igr, dtype, tol):
        gold, gerr = native.surfdisp_native(h0, vp0, vs0, rho0, PERIODS,
                                            iwave=iwave, igr=igr)
        layers = [jnp.asarray(a, dtype) for a in tutorial_layers(NL)]
        cg, err = surfdisp(*layers, jnp.asarray(PERIODS, dtype),
                           iwave=iwave, igr=igr)
        cg = np.asarray(jax.device_get(cg), np.float64)
        check(not gerr and not bool(err), '%s: solver error flag' % name)
        diff = float(np.max(np.abs(cg - gold)))
        check(diff <= tol, '%s: max |diff| %.3g > %.1g' % (name, diff,
                                                          tol))
        out[name] = diff

    def rf_case(name, dtype, tol):
        nsamp = RF_ARGS['nsamp']
        _, _, gold = native.synrf_native(
            h0, vp0, vs0, rho0, np.full(4, 500.0), np.full(4, 225.0),
            RF_ARGS['p_sdeg'], RF_ARGS['gauss_a'], nsamp,
            RF_ARGS['fsamp'], RF_ARGS['tshift'], vs0[0],
            (2 - 1.73 ** 2) / (2 - 2 * 1.73 ** 2), wave_type=P_WAVE)
        layers, qp, qs, poisson = _rf_inputs(dtype, NL)
        _, _, rf = synrf(*layers, qp, qs, RF_ARGS['p_sdeg'],
                         RF_ARGS['gauss_a'], nsamp, RF_ARGS['fsamp'],
                         RF_ARGS['tshift'], float(vs0[0]), poisson,
                         wave_type=P_WAVE)
        rf = np.asarray(jax.device_get(rf), np.float64)[:RF_NDATA]
        check(np.all(np.isfinite(rf)), '%s: non-finite RF' % name)
        diff = float(np.max(np.abs(rf - gold[:RF_NDATA])))
        check(diff <= tol, '%s: max |diff| %.3g > %.1g' % (name, diff,
                                                          tol))
        out[name] = diff

    f32 = jnp.float32
    swd_case('rayleigh_phase_f32', 2, 0, f32, TOL_PHASE)
    swd_case('rayleigh_group_f32', 2, 1, f32, TOL_GROUP)
    swd_case('love_phase_f32', 1, 0, f32, TOL_PHASE)
    swd_case('love_group_f32', 1, 1, f32, TOL_GROUP)
    rf_case('prf_f32', f32, TOL_RF)
    if f64:
        with jax.enable_x64(True):
            swd_case('rayleigh_phase_f64', 2, 0, jnp.float64,
                     TOL_F64_PHASE)
            rf_case('prf_f64', jnp.float64, TOL_F64_RF)
    return out


# ---------------------------------------------------------------------
# phase 3: likelihood laws against float64 numpy
# ---------------------------------------------------------------------

def likelihood_parity(rows=LIKE_ROWS, seed=0):
    """The Gaussian (rcond-truncated and dof-corrected) and exponential
    laws in f32 on the device vs f64 numpy, on correlated residuals
    drawn at r = 0.98 with per-row sigma.  Returns the max relative
    deviation per law (relative to |logL| + madist/2 of the row)."""
    import jax
    import jax.numpy as jnp
    from bayhunter_jax.ops import likelihood as lk

    n, corr, rcond = RF_NDATA, 0.98, 1e-5
    rs = np.random.RandomState(seed)
    lam, u = np.linalg.eigh(lk.gauss_correlation_matrix(corr, n))
    sigma = rs.uniform(0.003, 0.02, rows)
    # residuals = correlated noise at the row's sigma plus a small
    # misfit, so the quadratic form is not just its expectation
    ydiff = (rs.standard_normal((rows, n)) * np.sqrt(np.clip(lam, 0, None))
             ) @ u.T * sigma[:, None] \
        + 0.002 * np.sin(np.arange(n) / 7.0)[None, :]
    w_full, logdet = lk.gauss_whitener(corr, n, rcond=rcond)
    w_kept, logdet_kept = lk.gauss_whitener(corr, n, rcond=rcond,
                                            return_kept=True)
    LOG2PI = np.log(2 * np.pi)

    def ref_gauss(w, ld, k):
        q = np.sum((ydiff @ w) ** 2, axis=-1) / sigma ** 2
        return -0.5 * (k * LOG2PI + 2 * k * np.log(sigma) + ld) - 0.5 * q, q

    def ref_exp():
        d2 = ydiff ** 2
        quad = d2.sum(-1) + corr ** 2 * d2[:, 1:-1].sum(-1) \
            - 2 * corr * (ydiff[:, :-1] * ydiff[:, 1:]).sum(-1)
        q = quad / (sigma ** 2 * (1 - corr ** 2))
        ld = 2 * n * np.log(sigma) + (n - 1) * np.log(1 - corr ** 2)
        return -0.5 * (n * LOG2PI + ld) - 0.5 * q, q

    yd = jnp.asarray(ydiff, jnp.float32)
    sg = jnp.asarray(sigma, jnp.float32)
    laws = {
        'gauss_white': (
            jax.jit(jax.vmap(lambda d, s: lk.loglike_gauss_white(
                d, s, jnp.asarray(w_full, jnp.float32), logdet))),
            ref_gauss(w_full, logdet, n)),
        'gauss_white_dof': (
            jax.jit(jax.vmap(lambda d, s: lk.loglike_gauss_white_dof(
                d, s, jnp.asarray(w_kept, jnp.float32), logdet_kept))),
            ref_gauss(w_kept, logdet_kept, w_kept.shape[1])),
        'exp': (
            jax.jit(jax.vmap(lambda d, s: lk.loglike_exp(d, s, corr))),
            ref_exp()),
    }
    out = {}
    for name, (fn, (ref, q)) in laws.items():
        got = np.asarray(jax.device_get(fn(yd, sg)), np.float64)
        check(got.shape == (rows,) and np.all(np.isfinite(got)),
              '%s: bad output' % name)
        rel = float(np.max(np.abs(got - ref) / (np.abs(ref) + 0.5 * q)))
        check(rel <= LIKE_RTOL, '%s: max relative deviation %.3g > %.1g'
              % (name, rel, LIKE_RTOL))
        out[name] = rel
    return out


# ---------------------------------------------------------------------
# phases 4-5: the optimizer's main path
# ---------------------------------------------------------------------

def run_inversion(nchains, iters, savepath, seed=1, devices=None,
                  ntemps=1):
    """MCMC_Optimizer(...).mp_inversion() at the tutorial configuration
    (burn-in and main ``iters // 2`` each); returns the optimizer."""
    from bench import tutorial_problem
    from bayhunter_jax import MCMC_Optimizer

    joint, priors, initparams = tutorial_problem(iters // 2)
    # snapshot stride of two whole cycles: the fused-cycle production
    # dispatch (a stride finer than one cycle falls back to per-step
    # dispatch)
    initparams.update(nchains=nchains, savepath=savepath, station='st3',
                      maxmodels=max(1, (iters // 2) // 10), ntemps=ntemps,
                      gauss_dof_correction=True)
    opt = MCMC_Optimizer(joint, initparams=initparams, priors=priors,
                         random_seed=seed, devices=devices)
    opt.mp_inversion()
    return opt


def check_outputs(opt):
    """The reference's file set, all values finite (models NaN-padded
    beyond each chain's layer count), median logL risen from the first
    snapshot (one stride in) to the last.  Returns (logL0, logL1)."""
    data = opt.savepath
    names = ('models', 'likes', 'misfits', 'noise', 'vpvs')
    want = {'%s_config.pkl' % opt.station}
    want |= {'c%03d_%s%s.npy' % (c, ph, nm) for c in range(opt.nchains)
             for ph in ('p1', 'p2') for nm in names}
    missing = want - set(os.listdir(data))
    check(not missing, '%d output files missing, e.g. %s'
          % (len(missing), sorted(missing)[:3]))
    first, last = [], []
    for c in range(opt.nchains):
        for ph in ('p1', 'p2'):
            for nm in names:
                arr = np.load(os.path.join(data, 'c%03d_%s%s.npy'
                                           % (c, ph, nm)))
                if nm == 'models':
                    nl = arr.shape[1] // 2
                    vs_ok = np.isfinite(arr[:, :nl])
                    check(np.array_equal(vs_ok, np.isfinite(arr[:, nl:]))
                          and np.all(vs_ok[:, 0])
                          and not np.any(np.isinf(arr)),
                          'chain %d %s: malformed model rows' % (c, ph))
                else:
                    check(np.all(np.isfinite(arr)),
                          'chain %d %s%s: non-finite' % (c, ph, nm))
                if nm == 'likes':
                    if ph == 'p1':
                        first.append(arr[0])
                    else:
                        last.append(arr[-1])
    l0, l1 = float(np.median(first)), float(np.median(last))
    check(l1 > l0, 'median logL did not rise: %.2f -> %.2f' % (l0, l1))
    return l0, l1


def step_times(opt, reps=3):
    """Steady per-move step time (ms) of the optimizer's sampler on
    its final state: one step per move id through step_fn (compiled
    once per move id), repeated ``reps`` times."""
    import jax
    sampler = opt.sampler
    states = opt.final_states
    moves = {m for m in sampler.moves_for(0, 256)}
    out = {}
    for name, mid in STEP_MOVES:
        if mid not in moves and mid not in (2, 3):
            out[name] = None      # not in this configuration's move set
            continue
        jax.block_until_ready(sampler.step_fn(states, mid).logL)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(sampler.step_fn(states, mid).logL)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def reject_pct(states):
    import jax
    ff, pp = jax.device_get((states.fwdfail, states.proposed))
    return (100.0 * ff.sum() / max(pp.sum(), 1),
            100.0 * ff[:, 2].sum() / max(pp[:, 2].sum(), 1))


def steady_rate(opt, min_seconds=3.0):
    """Steady-state proposals/s of the optimizer's compiled production
    dispatch (whole fused-cycle programs) on its final state, timed
    after mp_inversion so no compilation falls inside the window.
    Returns (proposals/s, ms per iteration)."""
    import jax
    from bayhunter_jax.sampler.chain import (dispatch_cycles,
                                             scan_cycles_for)
    smp = opt.sampler
    states = opt.final_states        # donated by the cycles below
    block = scan_cycles_for(opt.nchains_padded) * smp.cycle_len
    states = dispatch_cycles(smp, states, 0, block)
    jax.block_until_ready(states.logL)
    t0 = time.perf_counter()
    its = 0
    while time.perf_counter() - t0 < min_seconds:
        states = dispatch_cycles(smp, states, 0, block)
        jax.block_until_ready(states.logL)
        its += block
    dt = time.perf_counter() - t0
    opt.final_states = states
    return opt.nchains * its / dt, 1e3 * dt / its


def main_path_phase(label, nchains, iters, clock, device, workdir):
    savepath = os.path.join(workdir, label)
    c0, n0 = clock.mark()
    t0 = time.perf_counter()
    opt = run_inversion(nchains, iters, savepath)
    wall = time.perf_counter() - t0
    c1, n1 = clock.mark()
    l0, l1 = check_outputs(opt)
    rej, rej_dim = reject_pct(opt.final_states)
    steps = step_times(opt)
    c2, _ = clock.mark()
    rate, ms_it = steady_rate(opt)
    print('[%s] mp_inversion %d chains x %d it: wall %.1f s, of it XLA '
          'compile %.1f s summed over %d programs (threads overlap) | '
          'steady %.0f proposals/s, %.2f ms/iteration (informational) | '
          'median logL %.1f -> %.1f | fwd_reject_pct %.3f (dim %.3f) | '
          'step ms %s (step compile %.1f s) | peak_bytes_in_use %s'
          % (label, nchains, iters, wall, c1 - c0, n1 - n0, rate, ms_it,
             l0, l1, rej, rej_dim,
             ' '.join('%s=%s' % (k, 'n/a' if v is None else '%.2f' % v)
                      for k, v in steps.items()),
             c2 - c1, peak_bytes(device)), flush=True)
    shutil.rmtree(savepath, ignore_errors=True)
    return opt


# ---------------------------------------------------------------------
# phase 6: tomography
# ---------------------------------------------------------------------

def tomo_phase(clock, device, ncells=8, chains_per_cell=32,
               iters=ITERS_TOMO, seed=3):
    """TomoInversion over ``ncells`` Rayleigh phase curves of scaled
    tutorial models."""
    import jax.numpy as jnp
    from bayhunter_jax.ops.swd import surfdisp
    from bayhunter_jax.parallel.tomo import TomoInversion

    rs = np.random.RandomState(seed)
    h, vp, vs, rho = tutorial_layers(NL)
    Y = []
    for scale in np.linspace(0.95, 1.05, ncells):
        cg, err = surfdisp(*(jnp.asarray(a, jnp.float32) for a in
                             (h, vp * scale, vs * scale, rho)),
                           jnp.asarray(PERIODS, jnp.float32))
        check(not bool(err), 'tomo data: solver error flag')
        Y.append(np.asarray(cg, np.float64))
    Y = np.asarray(Y) + rs.normal(0.0, 0.01, (ncells, PERIODS.size))
    c0, n0 = clock.mark()
    t0 = time.perf_counter()
    tomo = TomoInversion(PERIODS, Y, ref='rdispph',
                         chains_per_cell=chains_per_cell,
                         priors={'vs': (2.0, 5.0), 'layers': (1, 20),
                                 'vpvs': 1.73,
                                 'swdnoise_sigma': (1e-5, 0.05)},
                         initparams={'iter_burnin': iters // 2,
                                     'iter_main': iters // 2,
                                     'thickmin': 0.1},
                         random_seed=seed)
    summary = tomo.run(segment_iters=100)
    wall = time.perf_counter() - t0
    c1, n1 = clock.mark()
    vsm = summary['vs_median']
    check(vsm.shape == (ncells, summary['depth'].size)
          and np.all(np.isfinite(vsm))
          and np.all(np.isfinite(summary['logL_median'])),
          'tomography summary malformed')
    rej, rej_dim = reject_pct(tomo.final_states)
    print('[tomo] TomoInversion %d cells x %d chains x %d it: wall '
          '%.1f s, of it XLA compile %.1f s summed over %d programs | '
          'logL median over cells %.1f | fwd_reject_pct %.3f (dim '
          '%.3f) | peak_bytes_in_use %s'
          % (ncells, chains_per_cell, iters, wall, c1 - c0, n1 - n0,
             float(np.median(summary['logL_median'])), rej, rej_dim,
             peak_bytes(device)), flush=True)


# ---------------------------------------------------------------------
# --multi: the sharded path on four cards
# ---------------------------------------------------------------------

def multi_phase(clock, workdir, nchains=MULTI_CHAINS, iters=ITERS_MULTI,
                ndev=4):
    """mp_inversion with parallel tempering (ntemps=2) sharded over
    ``ndev`` devices, against the same configuration and seed on one
    device.  Sharded and unsharded runs are not bitwise equal (f32
    fusion order differs), so they are compared statistically:
    per-move acceptance rates within 2 percentage points and the
    10/50/90 % quantiles of the cold chains' final logL within 10 %
    of the one-device 10-90 % spread."""
    import jax
    devices = jax.devices()
    check(len(devices) >= ndev, '--multi needs %d devices, found %d'
          % (ndev, len(devices)))
    runs = {}
    for label, devs in (('sharded', devices[:ndev]),
                        ('one', devices[:1])):
        c0, n0 = clock.mark()
        t0 = time.perf_counter()
        opt = run_inversion(nchains, iters,
                            os.path.join(workdir, 'multi_' + label),
                            devices=devs, ntemps=2)
        wall = time.perf_counter() - t0
        c1, n1 = clock.mark()
        st = opt.final_states
        cold = opt.tempering_plan.cold_indices(opt.nchains_padded)
        acc, prop, logL, sacc, sprop = jax.device_get(
            (st.accepted, st.proposed, st.logL, st.swap_accepted,
             st.swap_proposed))
        rates = 100.0 * acc[cold].sum(0) / np.maximum(prop[cold].sum(0),
                                                      1)
        runs[label] = dict(opt=opt, rates=rates,
                           q=np.quantile(logL[cold], [0.1, 0.5, 0.9]),
                           swaps=(int(sacc.sum()), int(sprop.sum())))
        print('[multi:%s] %d device(s), %d cold chains x 2 rungs x %d '
              'it: wall %.1f s, XLA compile %.1f s summed (%d programs) | '
              'acceptance %% %s | logL q10/50/90 %s | swaps %d/%d'
              % (label, len(devs), nchains, iters, wall, c1 - c0, n1 - n0,
                 np.round(rates, 2).tolist(),
                 np.round(runs[label]['q'], 2).tolist(),
                 *runs[label]['swaps']), flush=True)
    opt = runs['sharded']['opt']
    st = opt.final_states
    ndev_used = len(st.logL.sharding.device_set)
    check(ndev_used == ndev, 'state spans %d devices, not %d'
          % (ndev_used, ndev))
    hlo = opt.sampler.cycle_mixed_fn.lower(st).compile().as_text()
    n_gather = hlo.count('all-gather')
    check(n_gather == 0, 'compiled cycle holds %d all-gathers' % n_gather)
    check(runs['sharded']['swaps'][1] > 0, 'no swaps proposed')
    drates = np.abs(runs['sharded']['rates'] - runs['one']['rates'])
    active = runs['one']['rates'] > 0
    spread = runs['one']['q'][2] - runs['one']['q'][0]
    dq = np.abs(runs['sharded']['q'] - runs['one']['q'])
    print('[multi] sharding spans %d devices, all-gathers in cycle %d, '
          'swaps proposed %d | max acceptance gap %.2f pp (band 2) | '
          'max logL quantile gap %.2f (band %.2f)'
          % (ndev_used, n_gather, runs['sharded']['swaps'][1],
             float(drates[active].max()), float(dq.max()),
             0.1 * spread), flush=True)
    check(np.all(drates[active] <= 2.0), 'acceptance rates outside band')
    check(np.all(dq <= 0.1 * spread), 'logL quantiles outside band')
    return ndev_used


# ---------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multi', action='store_true',
                    help='run only the 4-GPU sharded path and its '
                         '1-GPU comparison')
    args = ap.parse_args(argv)

    import jax
    from bayhunter_jax import device as devmod

    # phase 1: device — JAX falls back to the CPU by itself when the
    # CUDA plugin fails to load; refuse to go on there
    platform, kind, count = devmod.require_gpu()
    cache = devmod.enable_compile_cache()
    print('[device] platform=%s device_kind=%s count=%d compile_cache=%s'
          % (platform, kind, count, cache), flush=True)
    print('[device] nvidia-smi name, power.limit: %s'
          % devmod.nvidia_smi_name_power().replace('\n', ' | '),
          flush=True)
    dev = jax.devices()[0]
    clock = CompileClock()
    workdir = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        if args.multi:
            ndev = multi_phase(clock, workdir)
            print(result_line(platform, kind, ndev))
            return 0

        t0 = time.perf_counter()
        fw = forward_parity()
        print('[forward] max |diff| vs native f64 golden: %s (tol phase '
              '%.0e, group %.0e, rf %.0e; f64 phase %.0e, rf %.0e) | '
              '%.1f s' % (' '.join('%s=%.3g' % kv for kv in fw.items()),
                          TOL_PHASE, TOL_GROUP, TOL_RF, TOL_F64_PHASE,
                          TOL_F64_RF, time.perf_counter() - t0),
              flush=True)

        t0 = time.perf_counter()
        lk = likelihood_parity()
        print('[likelihood] %d rows, r=0.98, f32 on device vs f64 numpy, '
              'max relative deviation: %s (tol %.0e) | %.1f s'
              % (LIKE_ROWS, ' '.join('%s=%.3g' % kv for kv in lk.items()),
                 LIKE_RTOL, time.perf_counter() - t0), flush=True)

        main_path_phase('main-21', 21, ITERS_SMALL, clock, dev, workdir)
        main_path_phase('main-10240', 10240, ITERS_WIDE, clock, dev,
                        workdir)
        tomo_phase(clock, dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(result_line(platform, kind, count))
    return 0


if __name__ == '__main__':
    sys.exit(main())
