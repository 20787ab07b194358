"""Parallel-tempering (replica exchange) tests.

The tempering machinery is an extension beyond the reference (which
runs fully independent chains); these tests pin the swap mechanics,
the temperature-slot bookkeeping, sharded execution, and the two
statistical guarantees: the cold rung still samples the untempered
posterior, and tempering actually buys mode-hopping on a multimodal
target.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bayhunter_jax.sampler.chain import (build_sampler, dispatch_cycles,
                                         make_config)
from bayhunter_jax.sampler import tempering

DTYPE = jnp.float64

PRIORS = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 4),
          'vpvs': 1.73, 'mohoest': None, 'mantle': None,
          'swdnoise_corr': 0.0, 'swdnoise_sigma': 0.012,
          'rfnoise_corr': 0.92, 'rfnoise_sigma': 0.005}
INITPARAMS = {'propdist': (0.05, 0.05, 0.10, 0.005, 0.005),
              'acceptance': (0.0, 100.0), 'thickmin': 0.1,
              'lvz': None, 'hvz': None, 'rcond': 1e-5,
              'iter_burnin': 512, 'iter_main': 512}
NL = 5


class _GaussEval(object):
    """Analytic evaluator: Gaussian likelihood on the mean nucleus
    velocity — no forward solves, so tempering statistics can be
    pinned with long cheap runs.  ``centers``/``width`` define a
    (possibly multimodal) likelihood  sum_k N(mean_vs; c_k, width)."""

    def __init__(self, centers=(3.2,), width=0.1):
        self.centers = jnp.asarray(centers, DTYPE)
        self.width = float(width)

    def _logL(self, vs, n):
        mask = jnp.arange(vs.shape[-1]) < n
        mean_vs = jnp.sum(jnp.where(mask, vs, 0.0)) / n
        comps = -0.5 * ((mean_vs - self.centers) / self.width) ** 2
        return jax.scipy.special.logsumexp(comps)

    def eval_full(self, vs, z, n, vpvs, noise, cache, cell=0,
                  ring_width=16):
        return (self._logL(vs, n), jnp.zeros((2,), DTYPE),
                jnp.asarray(True), cache)

    def eval_cold(self, vs, z, n, vpvs, noise, cell=0):
        cache = ((jnp.zeros((1,), DTYPE), jnp.zeros((0,), DTYPE)),)
        return (self._logL(vs, n), jnp.zeros((2,), DTYPE),
                jnp.asarray(True), cache)

    def eval_noise(self, noise, cache, cell=0):
        # noise never moves here (fixed priors); keep protocol
        return jnp.zeros((), DTYPE), jnp.asarray(True)


def _build(centers=(3.2,), width=0.1):
    cfg = make_config(PRIORS, INITPARAMS, ['swd'], nl=NL, dtype=DTYPE)
    return build_sampler(_GaussEval(centers, width), cfg)


# ---------------------------------------------------------------------------
# ladder / layout
# ---------------------------------------------------------------------------

def test_ladder_geometric():
    b = tempering.make_ladder(4, 8.0)
    assert b[0] == 1.0
    np.testing.assert_allclose(b[-1], 1.0 / 8.0)
    # geometric: constant ratio between rungs
    np.testing.assert_allclose(np.diff(np.log(b)),
                               np.log(b[1] / b[0]), rtol=1e-12)
    np.testing.assert_array_equal(tempering.make_ladder(1, 10.0),
                                  np.ones(1))
    with pytest.raises(ValueError):
        tempering.make_ladder(3, 0.5)


def test_chain_betas_layout():
    betas = tempering.chain_betas(12, 3, 27.0)
    assert betas.shape == (12,)
    np.testing.assert_allclose(betas[::3], 1.0)       # cold rungs
    np.testing.assert_allclose(betas[2::3], 1.0 / 27.0)
    with pytest.raises(ValueError):
        tempering.chain_betas(10, 3, 27.0)
    plan = tempering.TemperingPlan(3, 27.0, 1,
                                   tempering.chain_betas(12, 3, 27.0))
    np.testing.assert_array_equal(plan.cold_indices(12),
                                  [0, 3, 6, 9])


# ---------------------------------------------------------------------------
# swap mechanics
# ---------------------------------------------------------------------------

def _states_with(sampler, nchains, ntemps, logL, tmax=10.0):
    betas = tempering.chain_betas(nchains, ntemps, tmax)
    states = sampler.init_states_host(0, nchains, betas=betas)
    return states._replace(logL=jnp.asarray(logL, DTYPE))


def test_swap_forced_accept_exchanges_payload():
    """A hot rung holding a much better model always swaps down."""
    smp = _build()
    swap = tempering.build_swap_fn(2, DTYPE)
    # 2 groups x 2 rungs; hot chains (1, 3) hold the high likelihood
    logL = np.array([-100.0, 0.0, -50.0, -10.0])
    states = _states_with(smp, 4, 2, logL)
    before_vs = np.asarray(states.vs).copy()
    before_beta = np.asarray(states.beta).copy()
    before_pd = np.asarray(states.propdist).copy()
    out = swap(states, 0)   # parity 0 pairs rungs (0, 1)

    # payload exchanged within each group
    np.testing.assert_array_equal(np.asarray(out.logL),
                                  logL[[1, 0, 3, 2]])
    np.testing.assert_array_equal(np.asarray(out.vs),
                                  before_vs[[1, 0, 3, 2]])
    # rung-bound quantities stay with their slot
    np.testing.assert_array_equal(np.asarray(out.beta), before_beta)
    np.testing.assert_array_equal(np.asarray(out.propdist), before_pd)
    # ladder diagnostics: each cold member proposed+accepted one swap
    np.testing.assert_array_equal(np.asarray(out.swap_proposed),
                                  [1, 0, 1, 0])
    np.testing.assert_array_equal(np.asarray(out.swap_accepted),
                                  [1, 0, 1, 0])


def test_swap_rejects_downhill():
    """A cold rung holding the better model keeps it (the exchange
    ratio is hugely negative)."""
    smp = _build()
    swap = tempering.build_swap_fn(2, DTYPE)
    logL = np.array([0.0, -1e6, -10.0, -1e6])
    states = _states_with(smp, 4, 2, logL)
    out = swap(states, 0)
    np.testing.assert_array_equal(np.asarray(out.logL), logL)


def test_swap_parity_pairs_correct_rungs():
    """Parity 1 pairs rungs (1, 2) in a 4-rung ladder; rungs 0 and 3
    are spectators."""
    smp = _build()
    swap = tempering.build_swap_fn(4, DTYPE)
    logL = np.array([-1.0, -100.0, 0.0, -3.0])   # one group, 4 rungs
    states = _states_with(smp, 4, 4, logL)
    out = swap(states, 1)
    # rung2's better model moves to rung1; 0 and 3 untouched
    np.testing.assert_array_equal(np.asarray(out.logL),
                                  logL[[0, 2, 1, 3]])


def test_swap_cache_follows_model():
    smp = _build()
    swap = tempering.build_swap_fn(2, DTYPE)
    logL = np.array([-100.0, 0.0])
    states = _states_with(smp, 2, 2, logL)
    tagged = jax.tree_util.tree_map(
        lambda x: x.at[1].set(7.0) if x.ndim >= 1 and x.shape[0] == 2
        else x, states.cache)
    states = states._replace(cache=tagged)
    out = swap(states, 0)
    y0 = np.asarray(out.cache[0][0])[0]
    np.testing.assert_allclose(y0, 7.0)


def test_swap_sharded_8dev_matches_1dev(cpu_devices):
    smp = _build()
    swap = tempering.build_swap_fn(2, DTYPE)
    nchains = 16
    logL = np.linspace(-50.0, 0.0, nchains)[::-1].copy()
    ref = np.asarray(swap(_states_with(smp, nchains, 2, logL)
                          ._replace(), 0).logL)

    mesh = Mesh(np.array(cpu_devices[:8]), ('chains',))
    sharding = NamedSharding(mesh, P('chains'))
    states = _states_with(smp, nchains, 2, logL)
    states = jax.device_put(states, sharding)
    out = swap(states, 0)
    assert len(out.logL.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(out.logL), ref)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def _run_production(smp, states, niter):
    it0 = int(np.asarray(states.iiter)[0])
    return dispatch_cycles(smp, states, it0, niter)


def test_cold_rung_samples_untempered_posterior():
    """The beta=1 rung of a tempered ensemble must sample the same
    posterior as an untempered run (unimodal Gaussian target: compare
    the first two moments of the ensemble)."""
    niter = 1536

    smp0 = _build(centers=(3.2,), width=0.15)
    s0 = smp0.init_states_host(1, 128)
    s0 = _run_production(smp0, s0, niter)
    mean0 = _ensemble_mean_vs(s0)

    smp1 = _build(centers=(3.2,), width=0.15)
    smp1, plan = tempering.attach(smp1, 256, ntemps=2, tmax=30.0,
                                  swap_every=1, dtype=DTYPE)
    s1 = smp1.init_states_host(2, 256, betas=plan.betas)
    s1 = _run_production(smp1, s1, niter)
    cold = plan.cold_indices(256)
    mean1 = _ensemble_mean_vs(s1, rows=cold)

    assert abs(np.mean(mean0) - 3.2) < 0.1
    assert abs(np.mean(mean1) - 3.2) < 0.1
    assert abs(np.mean(mean0) - np.mean(mean1)) < 0.12
    assert abs(np.std(mean0) - np.std(mean1)) < 0.12


def _ensemble_mean_vs(states, rows=None):
    vs = np.asarray(states.vs)
    n = np.asarray(states.n)
    if rows is not None:
        vs, n = vs[rows], n[rows]
    mask = np.arange(vs.shape[-1])[None, :] < n[:, None]
    return (vs * mask).sum(axis=1) / n


def test_tempering_hops_modes():
    """Bimodal target with a deep likelihood valley: tempered cold
    chains must cross between modes far more often than untempered
    chains (the raison d'etre of replica exchange)."""
    centers, width = (2.6, 4.4), 0.05
    nchains, nseg, seg = 64, 10, 256

    def mode_switches(smp, states, rows=None):
        it = int(np.asarray(states.iiter)[0])
        prev = None
        switches = 0
        for _ in range(nseg):
            states = dispatch_cycles(smp, states, it, seg)
            it += seg
            m = _ensemble_mean_vs(states, rows=rows) > 3.5
            if prev is not None:
                switches += int(np.sum(m != prev))
            prev = m
        return switches

    smp0 = _build(centers, width)
    sw0 = mode_switches(smp0, smp0.init_states_host(3, nchains))

    smp1 = _build(centers, width)
    smp1, plan = tempering.attach(smp1, 4 * nchains, ntemps=4,
                                  tmax=300.0, swap_every=1,
                                  dtype=DTYPE)
    s1 = smp1.init_states_host(4, 4 * nchains, betas=plan.betas)
    sw1 = mode_switches(smp1, s1, rows=plan.cold_indices(4 * nchains))

    # same number of cold chains on both sides; tempered must hop
    # at least 3x more (measured ~0-2 vs ~40+ under these settings)
    assert sw1 >= 3 * max(sw0, 1)


# ---------------------------------------------------------------------------
# ladder adaptation
# ---------------------------------------------------------------------------

def test_adapt_ladder_equalizes_rates():
    """The stochastic-approximation update widens high-rate gaps and
    narrows low-rate gaps, keeps both anchors, and is a no-op at the
    equal-rate fixed point."""
    betas = tempering.make_ladder(4, 100.0)
    rates = np.array([0.8, 0.3, 0.3])   # gap 0 swaps too easily
    out = tempering.adapt_ladder(betas, rates, step=0.5)
    T0, T1 = 1.0 / betas, 1.0 / out
    np.testing.assert_allclose(T1[0], 1.0)
    np.testing.assert_allclose(T1[-1], T0[-1])
    # gap 0 must widen (relative to the others)
    g0 = np.diff(T0) / (T0[-1] - 1.0)
    g1 = np.diff(T1) / (T1[-1] - 1.0)
    assert g1[0] > g0[0]
    assert np.all(np.diff(1.0 / out) > 0)   # still a proper ladder
    # fixed point: equal rates leave the ladder untouched
    same = tempering.adapt_ladder(betas, np.full(3, 0.4), step=0.5)
    np.testing.assert_allclose(same, betas, rtol=1e-12)


def test_rung_swap_rates_windowed():
    acc = np.array([3, 0, 1, 0, 5, 0, 0, 0])     # 2 groups x 4 rungs
    prop = np.array([10, 5, 2, 0, 10, 5, 2, 0])
    rates, nprop = tempering.rung_swap_rates(acc, prop, 4)
    np.testing.assert_allclose(rates, [8 / 20, 0 / 10, 1 / 4])
    np.testing.assert_array_equal(nprop, [20, 10, 4])
    prev = (acc // 2, prop // 2)
    rates_w, nprop_w = tempering.rung_swap_rates(acc, prop, 4,
                                                 prev=prev)
    np.testing.assert_array_equal(nprop_w, [10, 6, 2])


def test_optimizer_ladder_adaptation_runs():
    """Burn-in ladder adaptation on the cheap analytic evaluator:
    the per-gap swap rates must spread less after adaptation than the
    initial geometric ladder's, and the adapted ladder must stay
    anchored and monotone."""
    smp = _build(centers=(3.2,), width=0.05)
    smp, plan = tempering.attach(smp, 128, ntemps=4, tmax=500.0,
                                 swap_every=1, dtype=DTYPE)
    s = smp.init_states_host(9, 128, betas=plan.betas)

    it = int(np.asarray(s.iiter)[0])
    prev = None
    rung_betas = np.asarray(plan.betas[:4], float)
    rates0 = None
    nupd = 0
    for seg in range(12):
        s = dispatch_cycles(smp, s, it, 128)
        it += 128
        rates, nprop = tempering.rung_swap_rates(
            s.swap_accepted, s.swap_proposed, 4, prev=prev)
        if nprop.min() < 64:
            continue
        if rates0 is None:
            rates0 = rates
        prev = (np.asarray(s.swap_accepted),
                np.asarray(s.swap_proposed))
        nupd += 1
        rung_betas = tempering.adapt_ladder(rung_betas, rates,
                                            0.6 / (1 + nupd / 10))
        betas = np.tile(rung_betas, 32)
        s = s._replace(beta=jnp.asarray(betas, DTYPE))
    ratesN, _ = tempering.rung_swap_rates(
        s.swap_accepted, s.swap_proposed, 4, prev=prev)
    assert nupd >= 3
    assert np.all(np.diff(1.0 / rung_betas) > 0)
    np.testing.assert_allclose(rung_betas[0], 1.0)
    np.testing.assert_allclose(rung_betas[-1], 1.0 / 500.0)
    # adapted windowed rates must be less spread than the first window
    assert ratesN.max() - ratesN.min() <= rates0.max() - rates0.min()


# ---------------------------------------------------------------------------
# optimizer integration (real forward solver, tiny run)
# ---------------------------------------------------------------------------

def test_optimizer_tempered_run(tmp_path):
    """ntemps>1 runs heated replicas on the batch axis but keeps the
    reference output contract: nchains COLD chains on disk."""
    import os.path as op
    from bayhunter_jax import Targets, MCMC_Optimizer
    from bayhunter_jax.synthobs import SynthObs

    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    rs = np.random.RandomState(5)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)
    target = Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)
    targets = Targets.JointTarget(targets=[target])
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'nchains': 4, 'iter_burnin': 256, 'iter_main': 256,
                  'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'maxmodels': 16, 'savepath': str(tmp_path),
                  'station': 'temp', 'segment_seconds': 0.5,
                  'checkpoint_seconds': 0,
                  'ntemps': 2, 'tmax': 50.0, 'swap_every': 1}
    opt = MCMC_Optimizer(targets, initparams=initparams,
                         priors=priors, random_seed=11,
                         devices=jax.devices('cpu')[:1])
    assert opt.tempering_plan is not None
    assert opt.nchains_padded == 8          # 4 cold x 2 rungs
    betas = np.asarray(opt.tempering_plan.betas)
    np.testing.assert_allclose(betas[::2], 1.0)
    np.testing.assert_allclose(betas[1::2], 1.0 / 50.0)

    opt.mp_inversion()
    datadir = op.join(str(tmp_path), 'data')
    for c in range(4):
        assert op.exists(op.join(datadir,
                                 'c%.3d_p2models.npy' % c))
    assert not op.exists(op.join(datadir, 'c004_p2models.npy'))
    likes = np.load(op.join(datadir, 'c000_p2likes.npy'))
    assert np.all(np.isfinite(likes))
    # the saved chains are the beta=1 rung: final cold logL should be
    # in the same range as an equilibrated untempered run (sanity:
    # not the hot rung's flattened values)
    final_cold = np.asarray(opt.final_states.logL)[
        opt.tempering_plan.cold_indices(8)]
    assert np.all(np.isfinite(final_cold))
