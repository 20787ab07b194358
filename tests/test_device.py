"""Device guard and compile-cache rules (bayhunter_jax/device.py)."""

import pytest

from bayhunter_jax import device


def test_require_gpu_refuses_the_cpu():
    """The suite runs on the CPU: a measurement entry point must refuse
    to go on rather than fall back to it."""
    with pytest.raises(RuntimeError, match='no GPU'):
        device.require_gpu()


def test_cache_dir_honours_the_environment():
    env = {'JAX_COMPILATION_CACHE_DIR': '/elsewhere'}
    assert device.cache_dir_for('gpu', env) is None
    assert device.cache_dir_for('cpu', env) is None
    # a directory already configured in code is left alone too
    assert device.cache_dir_for('gpu', {}, configured='/mine') is None


def test_cache_dir_default_is_fixed_checkout_path():
    path = device.cache_dir_for('gpu', {})
    assert path == device.DEFAULT_CACHE_DIR
    assert path.endswith('.jax_cache')
    assert device.cache_dir_for('gpu', {}) == path   # stable
    # the CPU keeps no persistent cache unless asked
    assert device.cache_dir_for('cpu', {}) is None


def test_describe_reports_platform_kind_count(cpu_devices):
    platform, kind, count = device.describe(cpu_devices[:3])
    assert (platform, count) == ('cpu', 3)
    assert kind == cpu_devices[0].device_kind
