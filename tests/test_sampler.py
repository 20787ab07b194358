"""McMC sampler correctness tests (SURVEY.md §4 items c/d).

All on CPU in float64 via conftest; chains are tiny so the whole file
stays fast.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bayhunter_jax import Targets
from bayhunter_jax.synthobs import SynthObs
from bayhunter_jax.sampler.chain import build_sampler, make_config
from bayhunter_jax.sampler.evaluator import build_evaluator

DTYPE = jnp.float64

PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 10),
          'vpvs': 1.73, 'mohoest': None, 'mantle': None,
          'swdnoise_corr': 0.0, 'swdnoise_sigma': (1e-5, 0.05),
          'rfnoise_corr': 0.92, 'rfnoise_sigma': (1e-5, 0.05)}
INITPARAMS = {'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
              'acceptance': (40, 45), 'thickmin': 0.1,
              'lvz': None, 'hvz': None, 'rcond': 1e-5,
              'iter_burnin': 1000, 'iter_main': 1000}
NL = 11


def _swd_problem():
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    rs = np.random.RandomState(11)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)
    target = Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)
    return Targets.JointTarget(targets=[target])


@pytest.fixture(scope='module')
def sampler():
    joint = _swd_problem()
    cfg = make_config(PRIORS, INITPARAMS, ['swd'], nl=NL, dtype=DTYPE)
    ev = build_evaluator(joint, PRIORS, INITPARAMS, NL, dtype=DTYPE)
    return build_sampler(ev, cfg)


def test_init_states_host_valid(sampler):
    states = sampler.init_states_host(0, 16)
    assert states.vs.shape == (16, NL)
    assert np.all(np.isfinite(np.asarray(states.logL)))
    assert np.all(np.asarray(states.n) == PRIORS['layers'][0] + 1)
    # depths sorted over the active slots
    z = np.asarray(states.z)[:, :PRIORS['layers'][0] + 1]
    assert np.all(np.diff(z, axis=1) >= 0)


def test_seeded_determinism(sampler):
    s1 = sampler.init_states_host(42, 4)
    s2 = sampler.init_states_host(42, 4)
    a1, _ = sampler.run_fn(s1, 2, 25)
    a2, _ = sampler.run_fn(s2, 2, 25)
    np.testing.assert_array_equal(np.asarray(a1.logL),
                                  np.asarray(a2.logL))
    np.testing.assert_array_equal(np.asarray(a1.vs), np.asarray(a2.vs))


def test_sampling_improves_likelihood(sampler):
    states = sampler.init_states_host(1, 16)
    logL0 = np.median(np.asarray(states.logL))
    states, _ = sampler.run_fn(states, 4, 250)
    logL1 = np.median(np.asarray(states.logL))
    assert logL1 > logL0


def test_acceptance_counters(sampler):
    states = sampler.init_states_host(2, 8)
    states, _ = sampler.run_fn(states, 2, 25)
    acc = np.asarray(states.accepted)
    prop = np.asarray(states.proposed)
    assert np.all(acc <= prop)
    assert prop.sum() > 0


def test_snapshots_reference_layout(sampler):
    states = sampler.init_states_host(3, 4)
    _, snaps = sampler.run_fn(states, 2, 25)
    model = np.asarray(snaps['model'])
    assert model.shape == (2, 4, 2 * NL)  # (n_snap, chains, 2*NL)
    # NaN padding after the active nuclei, like the reference vectors
    n = PRIORS['layers'][0] + 1
    finite = np.isfinite(model)
    assert finite[..., :n].all()


def test_prior_only_sampling_recovers_prior():
    """With a constant likelihood the chain must sample the prior:
    layer count roughly uniform over its range and vs within bounds
    (SURVEY.md §4 test item c; validates the Bodin birth/death
    acceptance terms)."""
    joint = _swd_problem()
    # wide birth/death proposal width (fast transdimensional mixing at
    # the prior) and disabled width adaptation (acceptance window 0-100)
    initparams = dict(INITPARAMS,
                      propdist=(0.05, 0.05, 1.0, 0.005, 0.005),
                      acceptance=(0.0, 100.0))
    cfg = make_config(PRIORS, initparams, ['swd'], nl=NL, dtype=DTYPE)
    ev = build_evaluator(joint, PRIORS, initparams, NL, dtype=DTYPE)

    class FlatEval(object):
        eval_full = staticmethod(
            lambda vs, z, n, vpvs, noise, cache, cell=0, ring_width=16:
            (jnp.zeros((), DTYPE), jnp.zeros((2,), DTYPE),
             jnp.asarray(True), cache))
        eval_cold = staticmethod(
            lambda vs, z, n, vpvs, noise, cell=0:
            (jnp.zeros((), DTYPE), jnp.zeros((2,), DTYPE),
             jnp.asarray(True), ((jnp.zeros((1,), DTYPE),
                                  jnp.zeros((0,), DTYPE)),)))
        eval_noise = staticmethod(
            lambda noise, cache, cell=0: (jnp.zeros((), DTYPE),
                                          jnp.asarray(True)))

    smp = build_sampler(FlatEval(), cfg)
    states = smp.init_states_host(7, 64)
    states, snaps = smp.run_fn(states, 40, 200)  # 8000 iterations

    model = np.asarray(snaps['model'])  # (40, 64, 2*NL)
    nmax = PRIORS['layers'][1] + 1
    ns = np.isfinite(model[20:, :, :NL]).sum(axis=-1).ravel()
    # layer count must spread over the prior range, not collapse
    assert ns.min() <= 3
    assert ns.max() >= nmax - 1
    # vs samples stay inside the prior box
    vs_samples = model[20:, :, :NL]
    vs_samples = vs_samples[np.isfinite(vs_samples)]
    assert vs_samples.min() >= PRIORS['vs'][0] - 1e-9
    assert vs_samples.max() <= PRIORS['vs'][1] + 1e-9
    # mean layer count near the middle of the prior (uniform => ~6.5
    # nuclei for layers in [1,10] -> n in [2,11]); loose tolerance
    assert 4.5 < ns.mean() < 8.5


def test_eval_noise_matches_eval_cold(sampler):
    """The noise-move fast path must score identically to a full
    evaluation at the same hyperparameters (it reuses the cached
    synthetics of the current model)."""
    joint = _swd_problem()
    ev = build_evaluator(joint, PRIORS, INITPARAMS, NL, dtype=DTYPE)
    states = sampler.init_states_host(6, 4)
    vs = jnp.asarray(np.asarray(states.vs)[0])
    z = jnp.asarray(np.asarray(states.z)[0])
    n = jnp.asarray(np.asarray(states.n)[0])
    vpvs = jnp.asarray(np.asarray(states.vpvs)[0])
    noise = jnp.asarray(np.asarray(states.noise)[0])
    logL0, _, _, cache = ev.eval_cold(vs, z, n, vpvs, noise)
    noise2 = noise.at[1].mul(1.5)
    logL_fast, valid = ev.eval_noise(noise2, cache)
    logL_full, _, _, _ = ev.eval_cold(vs, z, n, vpvs, noise2)
    assert bool(valid)
    np.testing.assert_allclose(float(logL_fast), float(logL_full),
                               rtol=1e-12)


def test_all_six_targets_joint():
    """Every concrete target type in ONE joint inversion: 4 SWD
    (Rayleigh/Love x phase/group) + P and S receiver functions."""
    h = np.array([8., 25., 0.])
    vs = np.array([2.9, 3.6, 4.4])
    swd = SynthObs.return_swddata(h, vs, vpvs=1.73,
                                  x=np.linspace(3, 35, 9))
    rf = SynthObs.return_rfdata(h, vs, vpvs=1.73,
                                x=np.linspace(-5, 15, 81))
    targets = [
        Targets.RayleighDispersionPhase(*map(np.asarray,
                                             swd['rdispph'])),
        Targets.RayleighDispersionGroup(*map(np.asarray,
                                             swd['rdispgr'])),
        Targets.LoveDispersionPhase(*map(np.asarray, swd['ldispph'])),
        Targets.LoveDispersionGroup(*map(np.asarray, swd['ldispgr'])),
        Targets.PReceiverFunction(*map(np.asarray, rf['prf'])),
        Targets.SReceiverFunction(*map(np.asarray, rf['srf'])),
    ]
    joint = Targets.JointTarget(targets=targets)
    noiserefs = [t.noiseref for t in targets]
    priors = dict(PRIORS)
    initparams = dict(INITPARAMS, iter_burnin=60, iter_main=40)
    cfg = make_config(priors, initparams, noiserefs, nl=NL, dtype=DTYPE)
    ev = build_evaluator(joint, priors, initparams, NL, dtype=DTYPE)
    smp = build_sampler(ev, cfg)

    states = smp.init_states_host(3, 4)
    assert np.all(np.isfinite(np.asarray(states.logL)))
    assert np.asarray(states.misfits).shape == (4, 7)  # 6 targets+joint
    states, _ = smp.run_fn(states, 2, 50)
    logL = np.asarray(states.logL)
    assert np.all(np.isfinite(logL)) and np.all(logL > -1e14)


def test_cycle_matches_step_sequence(sampler):
    """The fused move cycle (one program) must be bit-identical to
    dispatching its moves one step_fn call at a time; the dimension
    slots take the per-cycle birth/death draw as static arguments."""
    from bayhunter_jax.sampler.chain import (MOVE_VS, MOVE_Z,
                                             MOVE_BIRTH, MOVE_DEATH,
                                             MOVE_NOISE)
    states = sampler.init_states_host(5, 8)
    copy = jax.tree_util.tree_map(jnp.copy, states)
    s_cyc = sampler.cycle_fn(copy, MOVE_DEATH, MOVE_BIRTH)  # donated
    s_seq = states
    for m in (MOVE_VS, MOVE_Z, MOVE_DEATH, MOVE_BIRTH, MOVE_NOISE):
        s_seq = sampler.step_fn(s_seq, int(m))
    for name in ('vs', 'z', 'n', 'vpvs', 'noise', 'logL', 'iiter',
                 'accepted', 'proposed', 'propdist'):
        np.testing.assert_array_equal(
            np.asarray(getattr(s_cyc, name)),
            np.asarray(getattr(s_seq, name)), err_msg=name)
    assert sampler.cycle_len == 5          # vs, z, 2 dim slots, noise

    # the per-cycle dimension-slot draw is deterministic in the
    # iteration counter and hits both move types
    draws = [sampler.dim_slots_for(i) for i in range(40)]
    assert sampler.dim_slots_for(7) == draws[7]
    flat = [d for pair in draws for d in pair]
    assert MOVE_BIRTH in flat and MOVE_DEATH in flat

    # early cycle excludes dimension moves (layer count unchanged)
    n_before = np.asarray(s_cyc.n).copy()
    s_e = sampler.cycle_early_fn(s_cyc)
    np.testing.assert_array_equal(np.asarray(s_e.n), n_before)


def test_static_step_matches_traced_run(sampler):
    """step_fn with STATIC move ids specializes propose() — it skips
    the depth re-sort for vs/noise/vpvs moves (an exact no-op: the
    state is already depth-sorted and the sort keys only on z,
    stably) and prunes the unused model-validity computation for
    noise/vpvs moves.  The specialization must match run_fn's fully
    traced path (lax.switch move dispatch, unconditional sort,
    select-combined validity) over the same move schedule.  Floats
    are compared to ~1 ulp, not bit-exactly: XLA fuses the two
    differently-structured programs differently (FMA contraction on
    the noise update was measured 1 ulp apart on CPU), but any real
    specialization bug (a wrongly skipped sort or validity check)
    diverges trajectories macroscopically through flipped accepts."""
    states_a = sampler.init_states_host(17, 8)
    states_b = sampler.init_states_host(17, 8)

    n_iter = 60
    states_a, _ = sampler.run_fn(states_a, 1, n_iter)
    for m in sampler.moves_for(-INITPARAMS['iter_burnin'], n_iter):
        states_b = sampler.step_fn(states_b, int(m))
    for name in ('n', 'iiter', 'accepted', 'proposed'):
        np.testing.assert_array_equal(
            np.asarray(getattr(states_a, name)),
            np.asarray(getattr(states_b, name)), err_msg=name)
    for name in ('vs', 'z', 'vpvs', 'noise', 'logL', 'propdist'):
        np.testing.assert_allclose(
            np.asarray(getattr(states_a, name)),
            np.asarray(getattr(states_b, name)),
            rtol=1e-13, atol=1e-15, err_msg=name)


def test_prior_only_dispatch_cycles_uniform_layer_histogram():
    """Long prior-only run through the PRODUCTION dispatch path
    (fused cycles with host-drawn dimension slots): the layer-count
    marginal must be uniform over the prior range, and must match the
    random-scan run_fn reference within sampling error (the
    birth/death slot mixture must not bias the transdimensional
    posterior)."""
    from bayhunter_jax.sampler.chain import dispatch_cycles

    initparams = dict(INITPARAMS,
                      propdist=(0.05, 0.05, 1.0, 0.005, 0.005),
                      acceptance=(0.0, 100.0))
    cfg = make_config(PRIORS, initparams, ['swd'], nl=NL, dtype=DTYPE)

    class FlatEval(object):
        eval_full = staticmethod(
            lambda vs, z, n, vpvs, noise, cache, cell=0, ring_width=16:
            (jnp.zeros((), DTYPE), jnp.zeros((2,), DTYPE),
             jnp.asarray(True), cache))
        eval_cold = staticmethod(
            lambda vs, z, n, vpvs, noise, cell=0:
            (jnp.zeros((), DTYPE), jnp.zeros((2,), DTYPE),
             jnp.asarray(True), ((jnp.zeros((1,), DTYPE),
                                  jnp.zeros((0,), DTYPE)),)))
        eval_noise = staticmethod(
            lambda noise, cache, cell=0: (jnp.zeros((), DTYPE),
                                          jnp.asarray(True)))

    smp = build_sampler(FlatEval(), cfg)
    nmin = PRIORS['layers'][0] + 1     # nuclei counts incl. halfspace
    nmax = PRIORS['layers'][1] + 1
    nbins = nmax - nmin + 1

    def n_hist_production(nchains, nseg, seg_iters, burn_segs):
        states = smp.init_states_host(7, nchains)
        it = 0                          # past early_cutoff: late cycles
        samples = []
        for s in range(nseg):
            states = dispatch_cycles(smp, states, it, seg_iters)
            it += seg_iters
            if s >= burn_segs:
                samples.append(np.asarray(states.n))
        ns = np.concatenate(samples)
        return np.bincount(ns, minlength=nmax + 1)[nmin:nmax + 1] \
            / ns.size

    def n_hist_runfn(nchains, n_snap, thin, burn_snaps):
        states = smp.init_states_host(7, nchains)
        _, snaps = smp.run_fn(states, n_snap, thin)
        model = np.asarray(snaps['model'])[burn_snaps:]
        ns = np.isfinite(model[..., :NL]).sum(axis=-1).ravel()
        return np.bincount(ns, minlength=nmax + 1)[nmin:nmax + 1] \
            / ns.size

    h_prod = n_hist_production(128, 40, 100, 15)  # 3200 samples
    h_run = n_hist_runfn(128, 40, 100, 15)

    uniform = 1.0 / nbins
    # production path: uniform within sampling tolerance, every bin.
    # The per-chain dimension coins make chains independent, so 3200
    # pooled samples estimate each bin to ~0.01; measured max
    # deviation 0.011 (this commit)
    assert np.all(np.abs(h_prod - uniform) < 0.035), h_prod
    # random-scan run_fn shares ONE move schedule across all chains,
    # which correlates the ensemble — its histogram is a much noisier
    # estimator (~25 effective time points), so only a loose
    # consistency check is meaningful
    assert np.all(np.abs(h_run - uniform) < 0.08), h_run
    assert abs(h_prod @ np.arange(nmin, nmax + 1)
               - h_run @ np.arange(nmin, nmax + 1)) < 0.5


def test_resort_states_is_exact_relabeling(sampler):
    """resort_states between dispatch segments must not change any
    chain's trajectory: chain randomness rides states.key (the host
    move schedule is chain-independent), so the sorted run's final
    states, matched back through perm, are bit-identical to the
    unsorted run's."""
    from bayhunter_jax.sampler.chain import dispatch_cycles, \
        resort_states

    C = 16
    states_a = sampler.init_states_host(9, C)
    states_b = jax.tree_util.tree_map(jnp.copy, states_a)
    it0 = -INITPARAMS['iter_burnin']
    # split/count on whole-cycle boundaries (the two arms must issue
    # identical dispatch sequences), past the early cutoff so
    # dimension moves diversify the layer counts being sorted on
    cel, clen = sampler.cycle_early_len, sampler.cycle_len
    n_early = int(np.ceil((sampler.early_cutoff - it0) / cel)) * cel
    half = n_early + 2 * clen
    count = n_early + 6 * clen

    # arm A: plain dispatch
    states_a = dispatch_cycles(sampler, states_a, it0, count)

    # arm B: dispatch with resorts interleaved
    perm = jnp.arange(C, dtype=jnp.int32)
    states_b = dispatch_cycles(sampler, states_b, it0, half)
    states_b, perm = resort_states(states_b, perm)
    states_b = dispatch_cycles(sampler, states_b, it0 + half,
                               count - half)
    states_b, perm = resort_states(states_b, perm)

    inv = np.argsort(np.asarray(perm))   # original chain -> row
    assert sorted(np.asarray(perm).tolist()) == list(range(C))
    # rows must actually be n-sorted after the resort
    n_b = np.asarray(states_b.n)
    assert np.all(np.diff(n_b) >= 0)
    for name in ('vs', 'z', 'n', 'vpvs', 'noise', 'logL', 'misfits',
                 'accepted', 'proposed', 'propdist', 'key'):
        np.testing.assert_array_equal(
            np.asarray(getattr(states_a, name)),
            np.asarray(getattr(states_b, name))[inv], err_msg=name)


def test_resort_states_block_keeps_groups(sampler):
    """block=k moves whole consecutive row blocks (temperature
    groups) together, keyed on each block's first (cold) row."""
    from bayhunter_jax.sampler.chain import resort_states

    C, k = 12, 3
    states = sampler.init_states_host(13, C)
    # distinctive per-row payloads to track rows (n drives the sort;
    # vpvs rides along) — copied to host BEFORE the donating call
    tag = jnp.arange(C, dtype=states.vpvs.dtype)
    rs = np.random.RandomState(4)
    n_in = rs.randint(2, 9, C).astype(np.asarray(states.n).dtype)
    states = states._replace(vpvs=tag,
                             n=jnp.asarray(n_in))
    tag_in = np.asarray(tag).copy()
    perm0 = jnp.arange(C, dtype=jnp.int32)
    out, perm = resort_states(states, perm0, block=k)

    order = np.argsort(n_in.reshape(-1, k)[:, 0], kind='stable')
    expect_rows = (order[:, None] * k + np.arange(k)).ravel()
    np.testing.assert_array_equal(np.asarray(perm), expect_rows)
    np.testing.assert_array_equal(np.asarray(out.vpvs),
                                  tag_in[expect_rows])
    np.testing.assert_array_equal(np.asarray(out.n),
                                  n_in[expect_rows])


def test_scan_cycles_match_single_cycle_dispatch(sampler, monkeypatch):
    """The on-device cycle scan (k whole mixed cycles per program via
    lax.scan) must reproduce single-cycle dispatch: the scan body is
    the same traced cycle, so the move sequence, counters and
    trajectories agree.  Continuous fields are compared to tight
    tolerance instead of bitwise — the scan program fuses the cycle
    body differently than the standalone cycle program (measured
    1e-18-level f64 differences; the same cross-program equivalence
    class as the sharded-vs-unsharded note in test_sharding8).
    Covers the early/late cutoff crossing (the scan must not run a
    late cycle before early_cutoff)."""
    from bayhunter_jax.sampler.chain import (dispatch_cycles,
                                             scan_cycles_for)
    # auto heuristic: floor-dominated small batches scan, big ones
    # not (conftest pins SCAN_CYCLES=1 suite-wide; lift it here)
    monkeypatch.delenv('BAYHUNTER_SCAN_CYCLES', raising=False)
    assert scan_cycles_for(21) == 16
    assert scan_cycles_for(512) == 8
    assert scan_cycles_for(10240) == 1

    count = 12 * sampler.cycle_len + 2   # + per-step remainder tail
    it0 = int(np.floor(sampler.early_cutoff)) - 2 * \
        sampler.cycle_early_len          # crosses the cutoff
    s1 = sampler.init_states_host(7, 8)
    s1 = s1._replace(iiter=jnp.full_like(s1.iiter, it0))
    s2 = jax.tree_util.tree_map(jnp.copy, s1)

    monkeypatch.setenv('BAYHUNTER_SCAN_CYCLES', '1')
    s1 = dispatch_cycles(sampler, s1, it0, count)
    monkeypatch.setenv('BAYHUNTER_SCAN_CYCLES', '4')
    s2 = dispatch_cycles(sampler, s2, it0, count)

    for name in ('n', 'iiter', 'accepted', 'proposed', 'fwdfail'):
        np.testing.assert_array_equal(
            np.asarray(getattr(s1, name)),
            np.asarray(getattr(s2, name)), err_msg=name)
    for name in ('vs', 'z', 'vpvs', 'noise', 'logL', 'propdist'):
        np.testing.assert_allclose(
            np.asarray(getattr(s1, name)),
            np.asarray(getattr(s2, name)), rtol=1e-9, atol=1e-12,
            err_msg=name)
