"""Production-path sharding tests at full virtual-mesh width: the
fused-cycle dispatch loop (sampler/chain.py dispatch_cycles) and the
optimizer must execute correctly with the chain batch sharded over all
8 virtual CPU devices (conftest), and the results must be independent
of the device layout.

This is the framework's replacement for the reference's process-pool
scale-out (reference: src/mcmcOptimizer.py:202-282): chains are data-
parallel over a 1-D ``Mesh(('chains',))``, so an n-device run must be
numerically identical to the single-device run chain by chain.
"""

import os.path as op

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bayhunter_jax import Targets, MCMC_Optimizer
from bayhunter_jax.synthobs import SynthObs
from bayhunter_jax.sampler.chain import (build_sampler, make_config,
                                         dispatch_cycles)
from bayhunter_jax.sampler.evaluator import build_evaluator

NCH = 16


def _tiny_sampler(nl=6):
    """Small SWD-only problem, float32 (the production dtype)."""
    import jax.numpy as jnp
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73,
                                   x=np.linspace(2., 30., 8))['rdispph']
    joint = Targets.JointTarget(targets=[
        Targets.RayleighDispersionPhase(np.asarray(x), np.asarray(y))])
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, nl - 1),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'iter_burnin': 512, 'iter_main': 512}
    cfg = make_config(priors, initparams, ['swd'], nl=nl,
                      dtype=jnp.float32)
    eval_fn = build_evaluator(joint, priors, initparams, nl,
                              dtype=jnp.float32)
    return build_sampler(eval_fn, cfg)


def _run_cycles(sampler, sharding=None):
    """Fresh-init NCH chains, optionally commit them to ``sharding``,
    and advance one production segment crossing the early->late
    transition (early cycles + per-step remainder + late cycles)."""
    states = sampler.init_states_host(0, NCH)
    if sharding is not None:
        states = jax.device_put(states, sharding)
    return _run_cycles_from(sampler, states)


def _run_cycles_from(sampler, states):
    it = int(sampler.early_cutoff) - sampler.cycle_early_len - 1
    count = 1 + sampler.cycle_early_len + 3 * sampler.cycle_len + 2
    states = dispatch_cycles(sampler, states, it, count)
    jax.block_until_ready(states.logL)
    return states


def test_dispatch_cycles_8dev_matches_1dev(cpu_devices):
    assert len(cpu_devices) >= 8, 'conftest must provision 8 devices'
    sampler = _tiny_sampler()

    ref = _run_cycles(sampler)  # default placement (single device)

    mesh = Mesh(np.array(cpu_devices[:8]), ('chains',))
    sharded = _run_cycles(sampler,
                          NamedSharding(mesh, P('chains')))

    # (ii) the result state actually carries the 8-way chain sharding
    assert len(sharded.logL.sharding.device_set) == 8

    # (i) chain-parallel execution is layout-independent: every chain's
    # trajectory identical to the single-device run
    np.testing.assert_array_equal(np.asarray(sharded.n),
                                  np.asarray(ref.n))
    np.testing.assert_allclose(np.asarray(sharded.logL),
                               np.asarray(ref.logL), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sharded.vs),
                               np.asarray(ref.vs), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sharded.z),
                               np.asarray(ref.z), rtol=1e-6,
                               atol=1e-6)
    assert np.all(np.isfinite(np.asarray(sharded.logL)))


def test_optimizer_8dev_full_run(cpu_devices, tmp_path):
    """MCMC_Optimizer end-to-end with the chain batch sharded 8-way
    through the production segment loop; same .npy output contract."""
    tmp = str(tmp_path)
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    rs = np.random.RandomState(3)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)
    joint = Targets.JointTarget(targets=[
        Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)])
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'nchains': 8, 'iter_burnin': 200, 'iter_main': 200,
                  'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'maxmodels': 20, 'savepath': tmp, 'station': 'mesh8',
                  'segment_seconds': 0.5, 'checkpoint_seconds': 0}
    opt = MCMC_Optimizer(joint, initparams=initparams, priors=priors,
                         random_seed=9, devices=cpu_devices[:8])

    states = opt._init_states()
    assert len(states.logL.sharding.device_set) == 8

    opt.mp_inversion()
    datadir = op.join(tmp, 'data')
    for c in range(8):
        f = op.join(datadir, 'c%.3d_p2models.npy' % c)
        assert op.exists(f), f
    likes = np.load(op.join(datadir, 'c000_p2likes.npy'))
    assert likes.size > 0 and np.all(np.isfinite(likes))


def test_shard_map_sampler_matches_and_avoids_gathers(cpu_devices):
    """build_sampler(mesh=...) shard_maps the dispatch programs: each
    device must run its own chain shard, root-search loops included
    (their batch-wide exit tests would otherwise reduce across
    devices every trip).  The shard_mapped cycle must (i) lower with
    zero all-gathers, and (ii) run the same Markov process as the
    meshless sampler."""
    import jax.numpy as jnp
    assert len(cpu_devices) >= 8

    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73,
                                   x=np.linspace(2., 30., 8))['rdispph']
    nl = 6
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, nl - 1),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'iter_burnin': 512, 'iter_main': 512}
    cfg = make_config(priors, initparams, ['swd'], nl=nl,
                      dtype=jnp.float32)

    def build(mesh):
        joint = Targets.JointTarget(targets=[
            Targets.RayleighDispersionPhase(np.asarray(x),
                                            np.asarray(y))])
        ev = build_evaluator(joint, priors, initparams, nl,
                             dtype=jnp.float32)
        return build_sampler(ev, cfg, mesh=mesh)

    mesh = Mesh(np.array(cpu_devices[:8]), ('chains',))
    sharding = NamedSharding(mesh, P('chains'))

    # (i) lowered HLO of the fused cycle: shard_mapped -> no
    # all-gather, no cross-device reduction; sharded output
    smp_mesh = build(mesh)
    states_p = smp_mesh.init_states_host(0, NCH)
    states_p = jax.device_put(states_p, sharding)
    hlo = smp_mesh.cycle_mixed_fn.lower(states_p).compile().as_text()
    assert 'all-gather' not in hlo, 'sharded cycle gathers the batch'
    assert 'all-reduce' not in hlo, 'sharded cycle reduces the batch'
    out = smp_mesh.cycle_mixed_fn(states_p)
    assert len(out.logL.sharding.device_set) == 8
    assert np.all(np.isfinite(np.asarray(out.logL)))

    # (ii) the shard_mapped sampler runs the same Markov process: the
    # partitioned module's fusion choices round f32 slightly
    # differently from the meshless module's, so marginal accept
    # decisions can flip (bitwise cross-module parity is not a
    # meaningful target) — assert statistical equivalence instead.
    # Fixed seeds make this deterministic, not flaky.
    smp_flat = build(None)
    states0 = smp_mesh.init_states_host(0, NCH)
    logL0 = np.median(np.asarray(jax.device_get(states0.logL)))
    sha = _run_cycles_from(smp_mesh,
                           jax.device_put(states0, sharding))
    ref = _run_cycles(smp_flat)
    assert len(sha.logL.sharding.device_set) == 8
    l_sha = np.asarray(sha.logL)
    l_ref = np.asarray(ref.logL)
    assert np.all(np.isfinite(l_sha))
    # both arms burn in from the same inits: medians improve and land
    # in the same range
    assert np.median(l_sha) > logL0
    assert abs(np.median(l_sha) - np.median(l_ref)) \
        < 0.2 * abs(np.median(l_ref)) + 50.0
    assert abs(float(np.mean(np.asarray(sha.n)))
               - float(np.mean(np.asarray(ref.n)))) < 1.0


def test_resort_states_sharded_within_shards(cpu_devices):
    """resort_states(mesh=...): each device sorts its OWN shard
    (chains never migrate), the perm stays a permutation, and the
    lowered program contains no cross-device collectives."""
    import jax.numpy as jnp
    from bayhunter_jax.sampler.chain import resort_states

    sampler = _tiny_sampler()
    C, ndev = 32, 8
    mesh = Mesh(np.array(cpu_devices[:ndev]), ('chains',))
    sharding = NamedSharding(mesh, P('chains'))

    states = sampler.init_states_host(3, C)
    rs = np.random.RandomState(8)
    n_in = rs.randint(2, 6, C).astype(np.asarray(states.n).dtype)
    states = states._replace(n=jnp.asarray(n_in))
    states = jax.device_put(states, sharding)
    perm0 = jax.device_put(jnp.arange(C, dtype=jnp.int32), sharding)

    lowered = resort_states.lower(states, perm0, 1, mesh)
    hlo = lowered.compile().as_text()
    for coll in ('all-gather', 'all-to-all', 'collective-permute'):
        assert coll not in hlo, coll

    out, perm = resort_states(states, perm0, 1, mesh)
    n_out = np.asarray(out.n)
    p_out = np.asarray(perm)
    local = C // ndev
    assert sorted(p_out.tolist()) == list(range(C))
    for d in range(ndev):
        sl = slice(d * local, (d + 1) * local)
        # sorted within the shard...
        assert np.all(np.diff(n_out[sl]) >= 0), d
        # ...and rows stayed on their device
        assert set(p_out[sl]) == set(range(d * local,
                                           (d + 1) * local)), d
        np.testing.assert_array_equal(n_out[sl], n_in[p_out[sl]])
    assert len(out.n.sharding.device_set) == ndev
