"""Native host solver bindings (ctypes).

``libbayhunter_native.so`` holds C++ goldens of the two forward
solvers (dispersion.cc, reflectivity.cc) — the same role the
reference's Fortran/C++ extensions play (reference: setup.py:15-33).
They are float64 goldens for the JAX solvers' tests and for
chip_smoke.py's forward phase, and a host solver for synthetic data;
no device path falls back to them.  Their numerical cores are TRANSLITERATIONS of the
reference's factoring by design (SURVEY.md §7), so they isolate
JAX-kernel bugs but cannot catch bugs inherited from the reference;
the independent anchors are the committed reference-output fixtures
and the conservation-law tests in tests/test_native_physics.py.  The
library is built on first import with the in-tree Makefile (g++); set
BAYHUNTER_NO_NATIVE=1 to skip.
"""

import ctypes
import logging
import os
import os.path as op
import subprocess

import numpy as np

logger = logging.getLogger(__name__)

_HERE = op.dirname(__file__)
_LIBPATH = op.join(_HERE, 'libbayhunter_native.so')
_lib = None


def _build():
    sources = [op.join(_HERE, s)
               for s in ('dispersion.cc', 'reflectivity.cc')]
    cmd = ['g++', '-O3', '-fPIC', '-std=c++17', '-shared',
           '-o', _LIBPATH] + sources
    subprocess.run(cmd, check=True, capture_output=True)


def load():
    """Load (building if needed) the native library; returns the
    ctypes handle or None when unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get('BAYHUNTER_NO_NATIVE'):
        return None
    try:
        if not op.exists(_LIBPATH) or (
                op.getmtime(_LIBPATH) < max(
                    op.getmtime(op.join(_HERE, s))
                    for s in ('dispersion.cc', 'reflectivity.cc'))):
            _build()
        lib = ctypes.CDLL(_LIBPATH)
    except Exception as exc:  # pragma: no cover
        logger.warning('native solvers unavailable: %s', exc)
        return None

    dp = ctypes.POINTER(ctypes.c_double)
    lib.bh_surfdisp.restype = ctypes.c_int
    lib.bh_surfdisp.argtypes = [dp, dp, dp, dp, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, dp, dp]
    lib.bh_synrf.restype = ctypes.c_int
    lib.bh_synrf.argtypes = [dp, dp, dp, dp, dp, dp, ctypes.c_int,
                             ctypes.c_double, ctypes.c_double,
                             ctypes.c_int, ctypes.c_double,
                             ctypes.c_double, ctypes.c_double,
                             ctypes.c_double, ctypes.c_int,
                             ctypes.c_int, ctypes.c_double,
                             dp, dp, dp]
    _lib = lib
    return _lib


def _as_c(arr):
    a = np.ascontiguousarray(np.asarray(arr, np.float64))
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def surfdisp_native(h, vp, vs, rho, periods, iwave=2, mode=1, igr=0,
                    iflsph=0):
    """Native dispersion solve; mirrors ops.swd.surfdisp's contract
    ``(cg, err)`` on unpadded or padded layer arrays."""
    lib = load()
    if lib is None:
        raise RuntimeError('native library unavailable')
    h_a, h_p = _as_c(h)
    vp_a, vp_p = _as_c(vp)
    vs_a, vs_p = _as_c(vs)
    rho_a, rho_p = _as_c(rho)
    t_a, t_p = _as_c(periods)
    cg = np.zeros(t_a.size, np.float64)
    _, cg_p = _as_c(cg)
    cg_ptr = cg.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    err = lib.bh_surfdisp(h_p, vp_p, vs_p, rho_p, h_a.size,
                          iflsph, iwave, mode, igr, t_a.size, t_p,
                          cg_ptr)
    return cg, bool(err)


def synrf_native(h, vp, vs, rho, qp, qs, p_sdeg, gauss_a, nsamp,
                 fsamp, tshift, nsv, poisson, wave_type=0,
                 flattening=True, fref=1.0):
    """Native RF synthesis; mirrors ops.rf.synrf's contract
    ``(fz, fr, rf)``."""
    lib = load()
    if lib is None:
        raise RuntimeError('native library unavailable')
    arrs = [_as_c(x) for x in (h, vp, vs, rho, qp, qs)]
    fz = np.zeros(nsamp, np.float64)
    fr = np.zeros(nsamp, np.float64)
    rf = np.zeros(nsamp, np.float64)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.bh_synrf(arrs[0][1], arrs[1][1], arrs[2][1], arrs[3][1],
                 arrs[4][1], arrs[5][1], arrs[0][0].size,
                 float(p_sdeg), float(gauss_a), int(nsamp),
                 float(fsamp), float(tshift), float(nsv),
                 float(poisson), int(wave_type), int(bool(flattening)),
                 float(fref), ptr(fz), ptr(fr), ptr(rf))
    return fz, fr, rf
