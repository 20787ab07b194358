"""Tests that need the GPU: the chip_smoke.py forward and likelihood
phases as tests, plus a short optimizer run on the card.  They carry
the ``gpu`` marker and skip on a machine without one (the decision is
made in the ``gpu_device`` fixture, never at import).  On the card:

    JAX_PLATFORMS= python -m pytest tests/ -m gpu
"""

import os
import sys

import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_forward_parity_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        out = _chip_smoke().forward_parity()
    assert len(out) == 7


def test_likelihood_parity_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        out = _chip_smoke().likelihood_parity()
    assert set(out) == {'gauss_white', 'gauss_white_dof', 'exp'}


def test_short_inversion_on_gpu(gpu_device, tmp_path):
    cs = _chip_smoke()
    with jax.default_device(gpu_device), jax.enable_x64(False):
        opt = cs.run_inversion(21, 200, str(tmp_path),
                               devices=[gpu_device])
        l0, l1 = cs.check_outputs(opt)
    assert opt.final_states.logL.devices() == {gpu_device}
    assert l1 > l0
