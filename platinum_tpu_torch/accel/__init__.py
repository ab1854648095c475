"""Copy of platinum_tpu/accel/__init__.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Acceleration structures: SAH BVH builders (C++ native + numpy oracle)."""

from __future__ import annotations


def get_builder():
    """Returns build_bvh(v0, v1, v2, max_leaf) → BVH, preferring the C++
    builder when its shared library has been compiled."""
    try:
        from platinum_tpu_torch.accel.native import build_bvh_native, native_available

        if native_available():
            return build_bvh_native
    except ImportError:
        pass
    from platinum_tpu_torch.accel.bvh import build_bvh

    return build_bvh
