"""Copy of platinum_tpu/utils/matrices.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Host-side 4x4 / 3x3 matrix builders (numpy, float32).

Capability parity with the reference's matrix helpers
(the Metal reference's src/utils/matrices.hpp:8-38): translation / rotation /
scaling / lookAt / perspective builders and 3x3 submatrix extraction, used by
the scene graph and camera setup. All matrices are column-major in the
mathematical sense (matrix @ column-vector), stored as numpy (4, 4) arrays.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(t, dtype=F)
    return m


def scaling(s) -> np.ndarray:
    s = np.asarray(s, dtype=F)
    if s.ndim == 0:
        s = np.array([s, s, s], dtype=F)
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotation3_x(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=F), np.sin(a, dtype=F)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=F)


def rotation3_y(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=F), np.sin(a, dtype=F)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=F)


def rotation3_z(a: float) -> np.ndarray:
    c, s = np.cos(a, dtype=F), np.sin(a, dtype=F)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=F)


def _to4(m3: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, :3] = m3
    return m


def rotation_x(a: float) -> np.ndarray:
    return _to4(rotation3_x(a))


def rotation_y(a: float) -> np.ndarray:
    return _to4(rotation3_y(a))


def rotation_z(a: float) -> np.ndarray:
    return _to4(rotation3_z(a))


def look_at(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """View matrix looking from `position` at `target` (right-handed, -Z fwd
    convention matching the reference's lookAt; its inverse is a camera-to-
    world transform whose +Z column points from target toward the camera)."""
    position = np.asarray(position, dtype=F)
    target = np.asarray(target, dtype=F)
    up = np.asarray(up, dtype=F)

    w = position - target
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    m = np.eye(4, dtype=F)
    m[0, :3] = u
    m[1, :3] = v
    m[2, :3] = w
    m[0, 3] = -np.dot(u, position)
    m[1, 3] = -np.dot(v, position)
    m[2, 3] = -np.dot(w, position)
    return m


def perspective(y_fov: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = F(1.0 / np.tan(y_fov * 0.5))
    m = np.zeros((4, 4), dtype=F)
    m[0, 0] = f / F(aspect)
    m[1, 1] = f
    m[2, 2] = F(far / (near - far))
    m[2, 3] = F(near * far / (near - far))
    m[3, 2] = F(-1.0)
    return m


def submatrix3(m: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(m[:3, :3], dtype=F)


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to points; p is (..., 3)."""
    p = np.asarray(p, dtype=F)
    return p @ m[:3, :3].T + m[:3, 3]


def transform_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=F)
    return v @ m[:3, :3].T


def transform_normal(m3: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Apply a 3x3 normal matrix (inverse-transpose of the linear part)."""
    n = np.asarray(n, dtype=F)
    return n @ m3.T


def normal_matrix_of(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the upper-left 3x3 of a 4x4 transform.

    Falls back to the pseudo-inverse for singular transforms (e.g. zero
    scale on an axis) so degenerate nodes don't crash scene flattening.
    """
    lin = m[:3, :3]
    try:
        return np.linalg.inv(lin).T.astype(F)
    except np.linalg.LinAlgError:
        return np.linalg.pinv(lin).T.astype(F)
