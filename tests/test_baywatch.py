"""Headless BayWatch client test: publisher wire format -> client
buffers -> plot rendering, without a live ZMQ stream."""

import os.path as op

import numpy as np
import pytest

import matplotlib
matplotlib.use('PDF')

from bayhunter_jax import Targets, utils
from bayhunter_jax.baywatch import BayWatcher
from bayhunter_jax.synthobs import SynthObs


@pytest.fixture(scope='module')
def baywatch_config(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('bw'))
    h = np.array([5., 23., 8., 0.])
    vs = np.array([2.7, 3.6, 3.8, 4.4])
    x, y = SynthObs.return_swddata(h, vs, vpvs=1.73)['rdispph']
    target = Targets.RayleighDispersionPhase(np.asarray(x),
                                             np.asarray(y))
    joint = Targets.JointTarget(targets=[target])
    priors = {'vs': (2.0, 5.0), 'z': (0.0, 60.0), 'layers': (1, 8),
              'vpvs': 1.73, 'swdnoise_corr': 0.0,
              'swdnoise_sigma': (1e-5, 0.05)}
    initparams = {'nchains': 3, 'iter_burnin': 100, 'iter_main': 100,
                  'station': 'bw', 'savepath': tmp}
    utils.save_baywatch_config(joint, path=tmp, priors=priors,
                               initparams=initparams)
    return op.join(tmp, 'baywatch.pkl')


def test_baywatch_store_and_plot(baywatch_config, tmp_path):
    bw = BayWatcher(configfile=baywatch_config, capacity=10)
    nchains = 3
    modellength = bw.modellength
    rs = np.random.RandomState(0)

    # feed a few telemetry frames in the optimizer's wire layout
    for _ in range(4):
        vs_m = np.sort(rs.uniform(2.5, 4.5, (nchains, modellength // 2)),
                       axis=1)
        z_m = np.sort(rs.uniform(0, 60, (nchains, modellength // 2)),
                      axis=1)
        model = np.concatenate([vs_m, z_m], 1).astype(np.float32)
        vpvs = np.full((nchains, 1), 1.73, np.float32)
        likes = rs.uniform(-100, -10, (nchains, 1)).astype(np.float32)
        noise = np.tile([0.0, 0.01],
                        (nchains, 1)).astype(np.float32)
        bw.store_data(np.concatenate([vpvs, model], axis=1))
        bw.store_data(likes)
        bw.store_data(noise)

    assert len(bw.likebuffer[0]) == 4
    assert len(bw.modelbuffer[0]) == 4
    assert bw.noisebuffer[0][-1].shape == (2,)

    bw.init_plot()
    bw.update_plot()
    out = str(tmp_path / 'bw.pdf')
    bw.fig.savefig(out)
    assert op.exists(out)


def test_baywatch_convergence_detection(baywatch_config):
    bw = BayWatcher(configfile=baywatch_config, capacity=5)
    frame = np.tile([0.0, 0.01], (3, 1)).astype(np.float32)
    likes = np.full((3, 1), -42.0, np.float32)
    model = np.full((3, bw.modellength + 1), 3.0, np.float32)
    # identical frames repeatedly -> chains frozen -> converged
    converged = False
    for _ in range(15):
        bw.store_data(model)
        bw.store_data(likes)
        bw.store_data(frame)
        converged = bw.check_convergence()
    assert converged
