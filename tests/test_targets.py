"""Targets / plugins / SynthObs host API parity tests."""

import numpy as np
import pytest

from bayhunter_jax import Targets
from bayhunter_jax.synthobs import SynthObs
from tests.conftest import golden_path


@pytest.fixture(scope='module')
def tutorial():
    return dict(h=np.array([5., 23., 8., 0.]),
                vs=np.array([2.7, 3.6, 3.8, 4.4]), vpvs=1.73)


def test_plugin_swd_golden(tutorial):
    x = np.linspace(1, 41, 21)
    target = Targets.RayleighDispersionPhase(x=x, y=None)
    vp = tutorial['vs'] * tutorial['vpvs']
    rho = vp * 0.32 + 0.77
    xmod, ymod = target.moddata.plugin.run_model(
        h=tutorial['h'], vp=vp, vs=tutorial['vs'], rho=rho)
    gold = np.loadtxt(golden_path('st3_rdispph.dat'))[:, 1]
    np.testing.assert_allclose(ymod, gold, atol=1e-4)


def test_plugin_rf_golden(tutorial):
    x = np.linspace(-5, 35, 201)
    target = Targets.PReceiverFunction(x=x, y=None)
    vp = tutorial['vs'] * tutorial['vpvs']
    rho = vp * 0.32 + 0.77
    xmod, ymod = target.moddata.plugin.run_model(
        h=tutorial['h'], vp=vp, vs=tutorial['vs'], rho=rho)
    gold = np.loadtxt(golden_path('st3_prf.dat'))[:, 1]
    assert xmod.size == 201
    np.testing.assert_allclose(ymod, gold, atol=2e-4)


def test_joint_evaluate_sentinels(tutorial):
    """Invalid forward output maps to the reference sentinels
    (src/Targets.py:325-328)."""
    x = np.linspace(1, 41, 21)
    y = np.loadtxt(golden_path('st3_rdispph.dat'))[:, 1]
    target = Targets.RayleighDispersionPhase(x=x, y=y)
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])

    # a pure-halfspace Love evaluation can't fail for Rayleigh; force an
    # invalid model instead: negative thickness produces garbage/failure
    class FailingPlugin:
        def run_model(self, h, vp, vs, rho, **kw):
            return np.nan, np.nan

    target.update_plugin(FailingPlugin())
    joint.evaluate(h=tutorial['h'], vp=tutorial['vs'] * 1.73,
                   vs=tutorial['vs'],
                   noise=np.array([0.0, 0.01]))
    assert joint.proposallikelihood == -1e15
    assert joint.proposalmisfits[0] == 1e15


def test_joint_evaluate_truth_likelihood(tutorial):
    """Joint evaluation at the truth model with noise-free data gives
    near-maximal likelihood (misfit ~ 0)."""
    x = np.linspace(1, 41, 21)
    y = np.loadtxt(golden_path('st3_rdispph.dat'))[:, 1]
    target = Targets.RayleighDispersionPhase(x=x, y=y)
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])
    vp = tutorial['vs'] * tutorial['vpvs']
    joint.evaluate(h=tutorial['h'], vp=vp, vs=tutorial['vs'],
                   noise=np.array([0.0, 0.012]))
    assert joint.proposalmisfits[-1] < 1e-3
    # ideal logL for zero misfit: -n/2 log(2 pi sigma^2)
    ideal = -0.5 * 21 * np.log(2 * np.pi) - 21 * np.log(0.012)
    assert abs(joint.proposallikelihood - ideal) < 1.0


def test_synthobs_swd_golden(tutorial):
    data = SynthObs.return_swddata(tutorial['h'], tutorial['vs'],
                                   vpvs=tutorial['vpvs'],
                                   x=np.linspace(1, 41, 21))
    for ref in ('rdispph', 'rdispgr', 'ldispph', 'ldispgr'):
        gold = np.loadtxt(golden_path('st3_%s.dat' % ref))[:, 1]
        np.testing.assert_allclose(data[ref][1], gold, atol=1e-3)


def test_synthobs_noise_statistics():
    obs = np.zeros(400)
    noise = SynthObs.compute_expnoise(obs, corr=0.5, sigma=0.02)
    assert abs(np.std(noise) - 0.02) < 0.005
    gnoise = SynthObs.compute_gaussnoise(obs, corr=0.9, sigma=0.01)
    assert abs(np.std(gnoise) - 0.01) < 0.004


def test_synthobs_explike_expected_value():
    """E[logL] at the truth equals -n/2 (log 2pi sigma^2 + 1) for
    uncorrelated noise — statistical oracle check."""
    rng = np.random.RandomState(11)
    n = 2000
    sigma = 0.01
    noise = rng.randn(n) * sigma
    ymod = np.zeros(n)
    logL = SynthObs.compute_explike(
        yobss=[noise], ymods=[ymod], noise=[0.0, sigma], gauss=[False])
    expect = -0.5 * n * (np.log(2 * np.pi * sigma ** 2) + 1)
    assert abs(logL - expect) / abs(expect) < 0.05


def test_custom_target_plugin_protocol():
    """templates/-style user plugin drop-in
    (reference: src/Targets.py:46-49, templates/myfwd.py)."""
    x = np.linspace(0, 10, 11)

    class MyForward:
        def run_model(self, h, vp, vs, rho, **kw):
            return x, np.full(11, float(np.sum(vs)))

    target = Targets.RayleighDispersionPhase(x=x, y=np.full(11, 10.1))
    target.update_plugin(MyForward())
    target.get_covariance = target.valuation.get_covariance_nocorr
    joint = Targets.JointTarget([target])
    joint.evaluate(h=np.array([1., 0.]), vp=np.array([6., 7.]),
                   vs=np.array([4., 6.1]), noise=np.array([0.0, 0.1]))
    assert abs(joint.proposalmisfits[0] - 0.0) < 1e-9
