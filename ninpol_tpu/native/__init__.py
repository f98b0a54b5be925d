"""Native (C++) topology engine loader.

Compiles ninpol_tpu/native/topology.cpp into a shared library on first use
(g++ -O3 -march=native, cached next to the source; ``make native`` builds
the same file) and exposes it through ctypes.  The library is not
version-controlled: it is rebuilt, and replaced atomically, whenever it
is missing or older than the source.  The NumPy implementation in
_grid/topology.py remains the portable fallback; ``available()`` gates
usage.  Set NINPOL_TPU_NATIVE=0 to disable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "topology.cpp")
_LIB = None
_TRIED = False

# topology arrays are int32 (entity counts < 2^31): halves the bytes
# the engine touches (first-touch page faults dominate cold builds
# in this microVM)
i32_p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def _build_lib_path():
    # Prefer a writable location next to the source; fall back to tempdir.
    for base in (_HERE, tempfile.gettempdir()):
        if os.access(base, os.W_OK):
            return os.path.join(base, "_ninpol_topology.so")
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("NINPOL_TPU_NATIVE", "1") == "0":
        return None
    path = _build_lib_path()
    if path is None:
        return None
    try:
        if (not os.path.exists(path)
                or os.path.getmtime(path) < os.path.getmtime(_SRC)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-shared", "-fPIC",
                 "-std=c++17", _SRC, "-o", path + ".tmp"],
                check=True, capture_output=True)
            os.replace(path + ".tmp", path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError):
        return None

    lib.build_esup.argtypes = [ctypes.c_int64] * 3 + [i32_p] * 5
    lib.build_esup.restype = None
    lib.build_psup.argtypes = [ctypes.c_int64] * 3 + [i32_p] * 7
    lib.build_psup.restype = ctypes.c_int64
    lib.build_faces.argtypes = ([ctypes.c_int64] * 3 + [i32_p] * 5
                                + [ctypes.c_int64] * 2 + [i32_p] * 5)
    lib.build_faces.restype = ctypes.c_int64
    lib.build_fsup.argtypes = [ctypes.c_int64] * 2 + [i32_p] * 3
    lib.build_fsup.restype = None
    lib.build_esuf.argtypes = [ctypes.c_int64] * 3 + [i32_p] * 5
    lib.build_esuf.restype = None
    lib.build_edges.argtypes = ([ctypes.c_int64] * 3 + [i32_p] * 2
                                + [i32_p] * 2 + [ctypes.c_int64]
                                + [i32_p] * 2)
    lib.build_edges.restype = ctypes.c_int64
    f64_p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.compute_centroids.argtypes = ([ctypes.c_int64] * 2 + [i32_p] * 3
                                      + [f64_p, ctypes.c_int64, f64_p])
    lib.compute_centroids.restype = None
    lib.compute_face_geometry.argtypes = (
        [ctypes.c_int64, i32_p, f64_p, ctypes.c_int64, ctypes.c_int64,
         f64_p, f64_p, f64_p])
    lib.compute_face_geometry.restype = None
    _LIB = lib
    return lib


def available():
    return _load() is not None


def lib():
    return _load()
