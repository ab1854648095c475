"""Copy of platinum_tpu/core/transform.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

TRS + look-at ("track") node transform (host-side).

Capability parity with the Metal reference's src/core/transform.hpp:19-80:
a transform is translation/rotation(Euler)/scale composed as T·Ry·Rx·Rz·S,
plus an optional look-at-target constraint that replaces the rotation. The
normal matrix is the inverse-transpose of the linear part (for pure
rotation+scale this reduces to transpose(R·S) with reciprocal scales; we
compute the general inverse-transpose which is equivalent and robust).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from platinum_tpu_torch.utils import matrices as mat

F = np.float32


class TransformType(enum.IntEnum):
    VECTOR = 0
    POINT = 1
    NORMAL = 2


@dataclass
class Transform:
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))  # Euler XYZ, radians
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))
    # Look-at constraint
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    track: bool = False

    def __post_init__(self):
        self.translation = np.asarray(self.translation, dtype=F).reshape(3)
        self.rotation = np.asarray(self.rotation, dtype=F).reshape(3)
        self.scale = np.asarray(self.scale, dtype=F).reshape(3)
        self.target = np.asarray(self.target, dtype=F).reshape(3)

    def _track_up(self) -> np.ndarray:
        # Degenerate pole case: camera directly above/below target
        if (self.translation[0] == self.target[0]
                and self.translation[2] == self.target[2]):
            return np.array([0, 0, 1], dtype=F)
        return np.array([0, 1, 0], dtype=F)

    def matrix(self) -> np.ndarray:
        t = mat.translation(self.translation)
        s = mat.scaling(self.scale)
        if self.track:
            look = np.linalg.inv(
                mat.look_at(self.translation, self.target, self._track_up())
            ).astype(F)
            return look @ s
        rx = mat.rotation_x(self.rotation[0])
        ry = mat.rotation_y(self.rotation[1])
        rz = mat.rotation_z(self.rotation[2])
        return t @ ry @ rx @ rz @ s

    def normal_matrix(self) -> np.ndarray:
        return mat.normal_matrix_of(self.matrix())

    def apply(self, v, kind: TransformType = TransformType.VECTOR) -> np.ndarray:
        m = self.matrix()
        if kind == TransformType.NORMAL:
            return mat.transform_normal(self.normal_matrix(), v)
        if kind == TransformType.POINT:
            return mat.transform_point(m, v)
        return mat.transform_vector(m, v)

    def copy(self) -> "Transform":
        return Transform(
            self.translation.copy(), self.rotation.copy(), self.scale.copy(),
            self.target.copy(), self.track,
        )
