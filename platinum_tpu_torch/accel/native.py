"""Copy of platinum_tpu/accel/native.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

ctypes binding to the native C++ BVH builder (accel/cpp/bvh_builder.cpp).

Auto-compiles the shared library on first use into
platinum_tpu_torch/_build/ (single translation unit, ~1s with g++ -O3);
falls back to the numpy builder (host code, the documented fallback) if no
compiler is available. Output layout is identical to accel.bvh.build_bvh.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from platinum_tpu_torch.accel.bvh import BVH

_DIR = os.path.join(os.path.dirname(__file__), "cpp")
# built beside the CUDA kernels, in the gitignored package build directory
_SO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "_build", "libptbvh.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO)
            < os.path.getmtime(os.path.join(_DIR, "bvh_builder.cpp"))
        ):
            # build under a private name, then rename: test workers that
            # build at once never load a half-written library
            tmp = f"{_SO}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["make", "-C", _DIR, "-s", f"OUT={tmp}"], check=True,
                    capture_output=True
                )
                os.replace(tmp, _SO)
            except (subprocess.CalledProcessError, FileNotFoundError):
                _build_failed = True
                return None
        lib = ctypes.CDLL(_SO)
        lib.ptbvh_build.restype = ctypes.c_void_p
        lib.ptbvh_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ptbvh_export.restype = None
        lib.ptbvh_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.ptbvh_free.restype = None
        lib.ptbvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     max_leaf: int = 4) -> BVH:
    lib = _load()
    if lib is None:
        from platinum_tpu_torch.accel.bvh import build_bvh

        return build_bvh(v0, v1, v2, max_leaf)

    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = len(v0)
    n_nodes = ctypes.c_int64(0)
    handle = lib.ptbvh_build(
        v0.ctypes.data, v1.ctypes.data, v2.ctypes.data,
        t, max_leaf, ctypes.byref(n_nodes),
    )
    try:
        n = n_nodes.value
        bounds_lo = np.empty((n, 3), np.float32)
        bounds_hi = np.empty((n, 3), np.float32)
        skip = np.empty(n, np.int32)
        tri_start = np.empty(n, np.int32)
        tri_count = np.empty(n, np.int32)
        tri_order = np.empty(t, np.int64)
        lib.ptbvh_export(
            handle,
            bounds_lo.ctypes.data, bounds_hi.ctypes.data,
            skip.ctypes.data, tri_start.ctypes.data, tri_count.ctypes.data,
            tri_order.ctypes.data,
        )
    finally:
        lib.ptbvh_free(handle)
    return BVH(bounds_lo, bounds_hi, skip, tri_start, tri_count, tri_order,
               max_leaf)
