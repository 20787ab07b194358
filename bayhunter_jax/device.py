"""Device bookkeeping shared by the entry points: which accelerator a
process runs on, the guard that refuses to time anything but a GPU,
and the persistent XLA compile cache.

Compile cache rules (:func:`cache_dir_for`):

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing
  here sets another directory;
* a directory already configured in code (``jax_compilation_cache_dir``)
  is left alone;
* otherwise, on an accelerator, the fixed path ``<checkout>/.jax_cache``
  (a fixed path, so that the next process finds what this one wrote);
* on the CPU, no cache: XLA:CPU executables have failed machine-feature
  detection on reload, so CPU runs (the test suite among them) opt in
  explicitly.

Enable the cache before the first compilation of the process: JAX
initialises its cache once, at the first compile.
"""

import logging
import os
import subprocess

import jax

logger = logging.getLogger(__name__)

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, '.jax_cache')


def cache_dir_for(platform, environ=None, configured=None):
    """The directory this process should configure, or None to leave
    JAX's setting as it is (see the module docstring)."""
    environ = os.environ if environ is None else environ
    if environ.get('JAX_COMPILATION_CACHE_DIR') or configured:
        return None
    if platform == 'cpu':
        return None
    return DEFAULT_CACHE_DIR


def enable_compile_cache():
    """Apply :func:`cache_dir_for` to this process; returns the cache
    directory in effect (None: no persistent cache)."""
    path = cache_dir_for(jax.default_backend(),
                         configured=jax.config.jax_compilation_cache_dir)
    if path is not None:
        jax.config.update('jax_compilation_cache_dir', path)
    return jax.config.jax_compilation_cache_dir


def describe(devices=None):
    """(platform, device_kind, count) of the devices a run uses, as
    JAX reports them."""
    devices = jax.devices() if devices is None else devices
    return devices[0].platform, devices[0].device_kind, len(devices)


def require_gpu():
    """Raise unless JAX's default devices are GPUs.  JAX falls back to
    the CPU on its own when the CUDA plugin fails to load; a timing or
    a smoke run must not quietly follow it there."""
    platform, kind, count = describe()
    if platform != 'gpu':
        raise RuntimeError(
            'no GPU: JAX runs on %r (%s, %d device(s)); this entry '
            'point measures the GPU only' % (platform, kind, count))
    return platform, kind, count


def nvidia_smi_name_power():
    """The card's ``name, power.limit`` as nvidia-smi reports them (one
    line per card), read in a child process that never touches JAX."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
