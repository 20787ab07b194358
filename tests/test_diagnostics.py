"""Convergence diagnostics (diagnostics.py): split-R-hat and ESS
against analytically known chains."""

import numpy as np

from bayhunter_jax.diagnostics import split_rhat, ess, \
    convergence_report


def _ar1(rs, m, n, phi, sigma=1.0):
    x = np.empty((m, n))
    x[:, 0] = rs.normal(0, sigma / np.sqrt(1 - phi ** 2), m)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + rs.normal(0, sigma, m)
    return x


def test_rhat_iid_near_one():
    rs = np.random.RandomState(0)
    x = rs.normal(size=(8, 2000))
    r = split_rhat(x)
    assert 0.99 < r < 1.01, r


def test_rhat_flags_disagreeing_chains():
    rs = np.random.RandomState(1)
    x = rs.normal(size=(8, 500))
    x[:4] += 5.0  # two populations of chains
    assert split_rhat(x) > 1.5


def test_rhat_flags_drift():
    """Within-chain drift must show up through the split halves."""
    rs = np.random.RandomState(2)
    n = 1000
    x = rs.normal(size=(8, n)) + np.linspace(0, 4, n)
    assert split_rhat(x) > 1.2


def test_rhat_degenerate_constant_chains():
    x = np.ones((4, 100))
    assert split_rhat(x) == 1.0
    x[2:] = 2.0
    assert split_rhat(x) == np.inf


def test_ess_iid_near_total():
    rs = np.random.RandomState(3)
    m, n = 8, 4000
    e = ess(rs.normal(size=(m, n)))
    assert 0.7 * m * n <= e <= m * n


def test_ess_ar1_matches_theory():
    """AR(1) with coefficient phi has tau = (1+phi)/(1-phi):
    phi=0.9 -> ESS ~ mn/19."""
    rs = np.random.RandomState(4)
    m, n, phi = 8, 20000, 0.9
    e = ess(_ar1(rs, m, n, phi))
    expect = m * n * (1 - phi) / (1 + phi)
    assert 0.6 * expect < e < 1.6 * expect, (e, expect)


def test_ess_constant_trace():
    assert ess(np.ones((4, 100))) == 400.0


def test_convergence_report_shapes_and_flags():
    rs = np.random.RandomState(5)
    good = rs.normal(size=(8, 1000))
    bad = rs.normal(size=(8, 1000))
    bad[:4] += 10.0
    rep = convergence_report({'good': good, 'bad': bad})
    assert rep['good']['converged']
    assert not rep['bad']['converged']
    assert rep['good']['ess_per_chain'] > 50
    # 1-D input treated as a single chain
    rep1 = convergence_report({'one': rs.normal(size=2000)})
    assert rep1['one']['ess'] > 500
