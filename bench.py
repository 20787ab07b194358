"""Headline benchmark: aggregate McMC proposal throughput for the
tutorial joint SWD+RF inversion at the 10,240-chain north-star
configuration (BASELINE.md) on one GPU.  BENCH_NCHAINS=512 for the
small-batch / latency-oriented figure.

Baseline (BASELINE.md): the reference's multiprocessing CPU run
achieves ~2,570 proposals/s aggregate (21 chains x 150k iterations in
20.4 min on an 8-core workstation, tutorial.rst:294-303).  One
proposal = one forward SWD solve + one forward RF solve + a
correlated-Gaussian likelihood, identical work per iteration here.

Refuses to time anything but a GPU.  Prints the device (platform,
device_kind, count, and nvidia-smi's name and power limit) on one
line, then one JSON line:
  {"metric": ..., "value": N, "unit": "proposals/s", "vs_baseline": N}
"""

import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

BASELINE_PROPOSALS_PER_S = 2570.0
NCHAINS = int(os.environ.get('BENCH_NCHAINS', 10240))
ITERS = int(os.environ.get('BENCH_ITERS', 2000))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'tests', 'fixtures')


def tutorial_problem(iters=None):
    """The tutorial joint inversion (reference tutorial/tutorialhunt.py
    :84-121): Rayleigh phase dispersion (21 periods) + P receiver
    function (201 samples, nsamp 512), layers (1, 20), rfnoise_corr
    0.98 with the rcond-truncated Gaussian law.  Returns
    ``(joint_target, priors, initparams)``; shared by this benchmark
    and chip_smoke.py so every measurement runs the same problem."""
    from bayhunter_jax import Targets

    iters = ITERS if iters is None else int(iters)
    swd = np.loadtxt(os.path.join(FIXTURES, 'st3_rdispph.dat'))
    prf = np.loadtxt(os.path.join(FIXTURES, 'st3_prf.dat'))
    targets = [Targets.RayleighDispersionPhase(swd[:, 0], swd[:, 1]),
               Targets.PReceiverFunction(prf[:, 0], prf[:, 1])]
    joint = Targets.JointTarget(targets=targets)
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 20),
              'vpvs': 1.73, 'mohoest': None, 'mantle': None,
              'swdnoise_corr': 0.0, 'swdnoise_sigma': (1e-5, 0.05),
              'rfnoise_corr': 0.98, 'rfnoise_sigma': (1e-5, 0.02)}
    initparams = {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'lvz': None, 'hvz': None, 'rcond': 1e-5,
                  'iter_burnin': iters, 'iter_main': iters}
    return joint, priors, initparams


def build(iters=None):
    """Tutorial-configuration sampler (nl = 21)."""
    from bayhunter_jax.sampler.chain import build_sampler, make_config
    from bayhunter_jax.sampler.evaluator import build_evaluator

    joint, priors, initparams = tutorial_problem(iters)
    nl = 21
    cfg = make_config(priors, initparams, ['swd', 'rf'], nl=nl)
    eval_fn = build_evaluator(joint, priors, initparams, nl)
    return build_sampler(eval_fn, cfg)


def _normalizer_gflops():
    """Same-call chip normalizer: sustained bf16 matmul rate on a fixed
    8192^3 problem.  A card's speed depends on its power limit and
    neighbours; recording this beside the headline number makes runs
    on different cards comparable."""
    n = 8192  # ~1.1 TFLOP/call: compute-bound, not dispatch-bound
    a = jnp.ones((n, n), jnp.bfloat16)
    b = jnp.ones((n, n), jnp.bfloat16)
    f = jax.jit(lambda x, y: x @ y)
    jax.block_until_ready(f(a, b))  # compile outside the timing
    t0 = time.time()
    reps = 20
    out = a
    for _ in range(reps):
        out = f(out, b)
    jax.block_until_ready(out)
    dt = time.time() - t0
    return 2.0 * n ** 3 * reps / dt / 1e9


def main():
    from bayhunter_jax import device
    from bayhunter_jax.sampler.chain import (dispatch_cycles,
                                             precompile_cycles,
                                             resort_states)

    platform, kind, count = device.require_gpu()
    device.enable_compile_cache()
    card = device.nvidia_smi_name_power()
    print('device: platform=%s kind=%s count=%d | nvidia-smi: %s'
          % (platform, kind, count, card), flush=True)

    sampler = build()
    states = sampler.init_states_host(0, NCHAINS)
    jax.block_until_ready(states.logL)

    # production hot path: fused move cycles (ONE device program per
    # sweep over the move set, input state donated) dispatched from
    # the host; see sampler/chain.py Sampler docstring.  thin is a
    # whole number of late-phase cycles so the timed region dispatches
    # only compiled cycle programs, never the per-step fallback.
    clen = sampler.cycle_len
    cel = sampler.cycle_early_len
    it = -ITERS
    thin = 8 * clen
    nseg = max(1, ITERS // thin)

    # warm-up: compile every dispatch program, clear the early phase
    # in whole early cycles, then run one untimed late segment so every
    # timed program is resident
    precompile_cycles(sampler, states)
    n_early = int(np.ceil(max(0.0, sampler.early_cutoff - it) / cel)) \
        * cel
    states = dispatch_cycles(sampler, states, it, n_early)
    it += n_early
    states = dispatch_cycles(sampler, states, it, thin, sync_every=0)
    it += thin
    jax.block_until_ready(states.logL)

    # BENCH_RESORT (default on): sort chains by layer count between
    # segments (exact relabeling, chain.resort_states), as the
    # optimizer does by default
    resort = os.environ.get('BENCH_RESORT', '1') == '1'
    if resort:
        perm = jnp.arange(NCHAINS, dtype=jnp.int32)
        states, perm = resort_states(states, perm)

    t0 = time.time()
    total = 0
    for _ in range(nseg):
        states = dispatch_cycles(sampler, states, it, thin,
                                 sync_every=0)
        it += thin
        total += thin
        if resort:
            states, perm = resort_states(states, perm)
        jax.block_until_ready(states.logL)
    dt = time.time() - t0

    rate = total * NCHAINS / dt
    norm = _normalizer_gflops()
    ff, pp = jax.device_get((states.fwdfail, states.proposed))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get('peak_bytes_in_use')
    dim_proposed = int(pp[:, 2].sum())
    print(json.dumps({
        'metric': 'joint SWD+RF McMC proposal throughput '
                  '(%d chains, 1 GPU)' % NCHAINS,
        'value': round(rate, 1),
        'unit': 'proposals/s',
        'vs_baseline': round(rate / BASELINE_PROPOSALS_PER_S, 2),
        'extra': {
            'device': {'platform': platform, 'kind': kind,
                       'count': count, 'nvidia_smi': card},
            'normalizer_bf16_matmul_gflops': round(norm, 1),
            'iters_timed': total,
            'nchains': NCHAINS,
            # forward-solve failures (sentinel rejects), as % of valid
            # proposals; slot 2 = birth/death
            'fwd_reject_pct': round(
                100.0 * ff.sum() / max(pp.sum(), 1), 3),
            'fwd_reject_dim_pct': (
                round(100.0 * ff[:, 2].sum() / dim_proposed, 3)
                if dim_proposed else None),
            'peak_bytes_in_use': peak,
        },
    }))


if __name__ == '__main__':
    main()
