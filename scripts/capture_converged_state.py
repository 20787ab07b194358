"""Capture a CONVERGED-regime ensemble snapshot as a test fixture.

Converged chains' dimension proposals are mostly structure-breaking,
so the converged regime needs its own pin of the forward-reject class.
This script runs the tutorial joint SWD+RF configuration at the
reference's own 21-chain operating point through burn-in plus a slice
of the main phase on the accelerator, then saves the small late-phase
state snapshot
(models, noise, adapted proposal widths) to
``tests/fixtures/converged_state_st3.npz`` for
``tests/test_dim_reject_converged.py`` to drive deterministically.

Usage: python scripts/capture_converged_state.py [nchains] [iters]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np

import jax

NCHAINS = int(sys.argv[1]) if len(sys.argv) > 1 else 21
ITERS = int(sys.argv[2]) if len(sys.argv) > 2 else 24576


def main():
    import bench
    from bayhunter_jax import device
    from bayhunter_jax.sampler.chain import dispatch_cycles, \
        precompile_cycles

    device.enable_compile_cache()
    sampler = bench.build(iters=ITERS)
    states = sampler.init_states_host(0, NCHAINS)
    precompile_cycles(sampler, states)

    # burn-in + 25% of main: safely in the converged regime
    # (posterior recovery is on target from the main phase onward)
    total = ITERS + ITERS // 4
    it = -ITERS
    done = 0
    chunk = 4096
    while done < total:
        k = min(chunk, total - done)
        states = dispatch_cycles(sampler, states, it, k)
        it += k
        done += k
        jax.block_until_ready(states.logL)
        print('iter %d / %d  logL med %.1f' % (
            done, total, float(np.median(np.asarray(states.logL)))),
            flush=True)

    ff, pp = jax.device_get((states.fwdfail, states.proposed))
    dim_rate = 100.0 * ff[:, 2].sum() / max(pp[:, 2].sum(), 1)
    print('cumulative dim fwd-reject over the whole run: %.2f%%'
          % dim_rate)

    out = os.path.join(os.path.dirname(__file__), '..', 'tests',
                       'fixtures', 'converged_state_st3.npz')
    np.savez_compressed(
        out,
        vs=np.asarray(states.vs), z=np.asarray(states.z),
        n=np.asarray(states.n), vpvs=np.asarray(states.vpvs),
        noise=np.asarray(states.noise),
        propdist=np.asarray(states.propdist),
        logL=np.asarray(states.logL),
        iiter=np.asarray(states.iiter))
    print('saved', out)


if __name__ == '__main__':
    main()
