"""Test configuration: run everything on CPU (8 virtual devices for
sharding tests) with x64 enabled for tight golden-data tolerances.

The production path runs float32 on the GPU; tests validate numerics
in float64 on CPU plus explicit float32-tolerance tests.  Tests that
need the GPU carry the ``gpu`` marker and skip here (see the
``gpu_device`` fixture).
"""

import os

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')
# the on-device cycle scan compiles 2 EXTRA programs per optimizer
# build (scan variants of the early/late cycles); on the compile-bound
# 1-core CI box that inflates every integration test, so the suite
# pins single-cycle dispatch — the scan path keeps its own dedicated
# equivalence test (test_scan_cycles_match_single_cycle_dispatch,
# which overrides this)
os.environ.setdefault('BAYHUNTER_SCAN_CYCLES', '1')

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)
# NOTE: no persistent compile cache for the CPU test suite BY DEFAULT
# — XLA's CPU AOT executables intermittently fail feature-detection
# on reload (SIGABRT), even for entries written on this very machine.
# BAYHUNTER_TEST_CACHE=1 opts in for local iteration (today's jax
# downgrades the mismatch to E-logs, but the SIGABRT history keeps
# the default off).
if os.environ.get('BAYHUNTER_TEST_CACHE') == '1':
    jax.config.update(
        'jax_compilation_cache_dir',
        os.path.join(os.path.dirname(__file__), '..',
                     '.jax_cache_cpu'))
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      1.0)

_CPU = jax.devices('cpu')[0]
jax.config.update('jax_default_device', _CPU)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_OBSERVED = '/root/reference/tutorial/observed'
FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def golden_path(name):
    """Golden data: committed fixtures generated by the reference
    solvers for the tutorial 4-layer model (preferred), falling back to
    the read-only reference checkout when present."""
    fix = os.path.join(FIXTURES, name)
    if os.path.exists(fix):
        return fix
    ref = os.path.join(REFERENCE_OBSERVED, name)
    if os.path.exists(ref):
        return ref
    pytest.skip('golden data %s not available' % name)


@pytest.fixture(scope='session')
def tutorial_model():
    """The reference tutorial's 4-layer truth model
    (reference: tutorial/create_testdata.py:13-17)."""
    return dict(h=np.array([5., 23., 8., 0.]),
                vs=np.array([2.7, 3.6, 3.8, 4.4]),
                vpvs=1.73)


@pytest.fixture(scope='session')
def cpu_devices():
    return jax.devices('cpu')


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided when a test asks for it —
    never at import time, so every test worker collects the same
    tests."""
    try:
        gpus = jax.devices('gpu')
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip('needs a GPU (run: JAX_PLATFORMS= python -m pytest '
                    'tests/ -m gpu)')
    return gpus[0]
