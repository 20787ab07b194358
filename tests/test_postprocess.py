"""End-to-end post-processing tests: optimizer output contract ->
PlotFromStorage (outliers, final distribution, plots, PDF merge), the
BayWatch ZMQ wire format, and the config loaders."""

import glob
import os
import os.path as op

import numpy as np
import pytest

import matplotlib
matplotlib.use('PDF')

from bayhunter_jax import Targets, MCMC_Optimizer, PlotFromStorage
from bayhunter_jax import utils
from bayhunter_jax.synthobs import SynthObs


@pytest.fixture(scope='module')
def mini_opt(tmp_path_factory):
    """A tiny SWD-only inversion producing the reference file layout.
    Returns (savepath, optimizer) — tests share the compiled programs.
    """
    tmp = str(tmp_path_factory.mktemp('run'))
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    rs = np.random.RandomState(3)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)
    target = Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)
    targets = Targets.JointTarget(targets=[target])
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'nchains': 6, 'iter_burnin': 300, 'iter_main': 300,
                  'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                  'acceptance': (40, 45), 'thickmin': 0.1,
                  'maxmodels': 30, 'savepath': tmp, 'station': 'mini',
                  # keep ONE compiled segment size (fast CI)
                  'segment_seconds': 0.5, 'checkpoint_seconds': 0}
    import jax
    opt = MCMC_Optimizer(targets, initparams=initparams, priors=priors,
                         random_seed=9, devices=jax.devices('cpu')[:1])
    opt.mp_inversion()
    return tmp, opt


@pytest.fixture(scope='module')
def mini_run(mini_opt):
    return mini_opt[0]


def test_output_contract(mini_run):
    """Per-chain .npy layout matches the reference
    (reference: src/SingleChain.py:665-690)."""
    datadir = op.join(mini_run, 'data')
    for c in range(6):
        for phase in ('p1', 'p2'):
            for name in ('models', 'likes', 'misfits', 'noise', 'vpvs'):
                f = op.join(datadir, 'c%.3d_%s%s.npy' % (c, phase, name))
                assert op.exists(f), f
    models = np.load(op.join(datadir, 'c000_p2models.npy'))
    likes = np.load(op.join(datadir, 'c000_p2likes.npy'))
    assert models.ndim == 2 and models.shape[1] == 2 * 9  # 2*(maxlay+1)
    assert likes.shape[0] == models.shape[0]
    assert op.exists(op.join(datadir, 'mini_config.pkl'))


def test_plot_from_storage_full_pipeline(mini_run):
    configfile = op.join(mini_run, 'data', 'mini_config.pkl')
    obj = PlotFromStorage(configfile)
    obj.save_final_distribution(maxmodels=200, dev=0.5)
    datadir = op.join(mini_run, 'data')
    for name in ('models', 'likes', 'misfits', 'noise', 'vpvs'):
        assert op.exists(op.join(datadir, 'c_%s.npy' % name))
    obj.save_plots(nchains=3)
    obj.merge_pdfs()
    figs = glob.glob(op.join(mini_run, 'c_*.pdf'))
    assert len(figs) >= 10
    assert op.exists(op.join(mini_run, 'c_summary.pdf'))
    assert op.exists(op.join(mini_run, 'data', 'outliers.dat'))


def test_baywatch_wire_roundtrip():
    zmq = pytest.importorskip('zmq')
    from bayhunter_jax.utils import SerializingContext
    ctx = SerializingContext()
    pub = ctx.socket(zmq.PUB)
    sub = ctx.socket(zmq.SUB)
    pub.bind('inproc://wiretest')
    sub.connect('inproc://wiretest')
    sub.setsockopt(zmq.SUBSCRIBE, b'')
    import time
    time.sleep(0.1)
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    pub.send_array(arr)
    got = sub.recv_array()
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == np.float32
    pub.close()
    sub.close()


def test_config_loader_tutorial_ini():
    ini = op.join(op.dirname(__file__), '..', 'tutorial', 'config.ini')
    priors, initparams = utils.load_params(ini)
    assert priors['vpvs'] == (1.4, 2.1)
    assert priors['layers'] == (1, 20)
    assert priors['mohoest'] is None
    assert priors['swdnoise_corr'] == 0.0
    assert initparams['iter_burnin'] == 2048 * 16
    assert initparams['station'] == 'test'
    # scalar prior => fixed parameter; tuple => inverted for
    assert isinstance(priors['swdnoise_corr'], float)
    assert isinstance(priors['rfnoise_sigma'], tuple)


def test_checkpoint_roundtrip_and_resume(mini_opt):
    import jax
    tmp, opt = mini_opt

    states = opt._init_states()
    parts = [opt._snapshot_host(states)]
    opt.save_checkpoint(states, 1, 120, parts)
    loaded = opt.load_checkpoint()
    assert loaded is not None
    states2, phase, it_done, parts2 = loaded
    assert phase == 1 and it_done == 120 and len(parts2) == 1
    for a, b in zip(jax.tree_util.tree_leaves(states),
                    jax.tree_util.tree_leaves(states2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(parts2[0]['model'],
                                  parts[0]['model'])

    # resume completes the run and clears the checkpoint
    opt.mp_inversion(resume=True)
    assert not op.exists(opt.ckptfile)
    assert op.exists(op.join(tmp, 'data', 'c000_p2models.npy'))


def test_save_read_config_pickle(tmp_path, mini_run):
    outfile = str(tmp_path / 'cfg.pkl')
    h = np.array([5., 0.])
    x = np.linspace(1, 20, 5)
    target = Targets.RayleighDispersionPhase(x, np.ones(5) * 3.0)
    joint = Targets.JointTarget(targets=[target])
    utils.save_config(joint, outfile, priors={'vs': (2, 5)},
                      initparams={'station': 'x'})
    back = utils.read_config(outfile)
    assert back['priors']['vs'] == (2, 5)
    assert len(back['targets']) == 1
    assert back['targets'][0].ref == 'rdispph'


def test_load_params_user_station_workflow(tmp_path):
    """Station-oriented config loader with a [datapaths] section
    (reference: src/utils.py:71-99): path templating by station,
    RF slowness read from the data-file comment."""
    obs = tmp_path / 'observed'
    obs.mkdir()
    (obs / 'ST01_rdispph.dat').write_text('10.0 3.1\n20.0 3.5\n')
    (obs / 'ST01_prf_7.dat').write_text(
        'timeaxis rfdata\n# 6.40\n-5.0 0.0\n0.0 0.5\n')
    ini = tmp_path / 'station.ini'
    ini.write_text("""[datapaths]
swd_rdispph = %s/%%s_rdispph.dat
rf_prf.bin = %s/%%s_prf_%%d.dat

[modelpriors]
vs = 2, 5
z = 0, 60
layers = 1, 10
vpvs = 1.73
swdnoise_corr = 0.
swdnoise_sigma = 1e-5, 0.05
rfnoise_corr = 0.9
rfnoise_sigma = 1e-5, 0.05

[initparams]
nchains = 2
iter_burnin = 10
iter_main = 10
propdist = 0.015, 0.015, 0.015, 0.005, 0.005
acceptance = 40, 45
thickmin = 0.1
rcond = 1e-5
station = 'x'
savepath = 'results_%%s_%%s'
maxmodels = 10
""" % (obs, obs))

    paths, priors, initparams = utils.load_params_user(str(ini), 'ST01',
                                                       slowness=7)
    assert paths['rdispph'].endswith('ST01_rdispph.dat')
    assert paths['prf.bin'].endswith('ST01_prf_7.dat')
    assert paths['slowness.bin'] == 6.40
    assert initparams['station'] == 'ST01'
    assert priors['layers'] == (1, 10)


def test_rrf_estimate_monotone_filter_width():
    """The r_RF estimator (utils.rrf_estimate) maps noise correlation
    to an RF Gauss filter width: stronger correlation concentrates the
    noise spectrum at low frequency, so the fitted width ``a`` must
    decrease monotonically with r_RF and land in the physical range
    the reference's estimator table spans (reference:
    src/utils.py:357-395)."""
    rrfs, a_est = utils.rrf_estimate({'rrfs': [0.85, 0.92, 0.97],
                                      'draws': 4000})
    assert list(rrfs) == sorted(rrfs)
    assert all(a1 > a2 for a1, a2 in zip(a_est, a_est[1:])), a_est
    assert 0.5 < a_est[-1] < a_est[0] < 8.0, a_est


def test_resort_chains_identical_outputs(tmp_path):
    """initparams['resort_chains']: the segment-boundary chain resort
    is an exact relabeling (chain.resort_states), so every per-chain
    .npy output must be IDENTICAL to the un-resorted run — the
    snapshot path restores original chain identity through the perm."""
    import jax

    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    rs = np.random.RandomState(3)
    ynoisy = np.asarray(y) + 0.012 * rs.normal(size=np.asarray(y).size)

    outs = {}
    for resort in (False, True):
        tmp = str(tmp_path / ('resort_%d' % resort))
        target = Targets.RayleighDispersionPhase(np.asarray(x), ynoisy)
        targets = Targets.JointTarget(targets=[target])
        priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
                  'vpvs': 1.73, 'swdnoise_corr': 0.0,
                  'swdnoise_sigma': (1e-5, 0.05)}
        initparams = {'nchains': 6, 'iter_burnin': 300,
                      'iter_main': 300,
                      'propdist': (0.015, 0.015, 0.015, 0.005, 0.005),
                      'acceptance': (40, 45), 'thickmin': 0.1,
                      'maxmodels': 30, 'savepath': tmp,
                      'station': 'mini', 'segment_seconds': 0.5,
                      'checkpoint_seconds': 0,
                      # pinned segmentation: identical move sequences
                      # are only guaranteed under equal segmentation
                      # (see optimizer segment_iters)
                      'segment_iters': 50,
                      # per-step dispatch: the resort/perm contract is
                      # dispatch-agnostic, and the fused-cycle programs
                      # dominate this test's compile time (2 full
                      # optimizer builds; was 345 s of a 57-min suite)
                      'fused_cycles': False,
                      'resort_chains': resort}
        opt = MCMC_Optimizer(targets, initparams=initparams,
                             priors=priors, random_seed=9,
                             devices=jax.devices('cpu')[:1])
        opt.mp_inversion()
        outs[resort] = tmp

    for c in range(6):
        for phase in ('p1', 'p2'):
            for name in ('models', 'likes', 'misfits', 'noise',
                         'vpvs'):
                f = 'c%03d_%s%s.npy' % (c, phase, name)
                a = np.load(op.join(outs[False], 'data', f))
                b = np.load(op.join(outs[True], 'data', f))
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_convergence_report_from_storage(mini_run):
    """PlotFromStorage.convergence_report: split-R-hat/ESS over the
    stored per-chain traces (diagnostics.py)."""
    from bayhunter_jax import PlotFromStorage
    configfile = op.join(mini_run, 'data', 'mini_config.pkl')
    obj = PlotFromStorage(configfile)
    rep = obj.convergence_report()
    assert set(rep) == {'likes', 'vpvs'}
    for d in rep.values():
        assert np.isfinite(d['rhat']) or d['rhat'] == np.inf
        assert d['ess'] > 0
    # vpvs is fixed in the mini run -> constant chains -> rhat 1
    assert rep['vpvs']['rhat'] == 1.0
