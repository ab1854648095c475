"""Copy of platinum_tpu/core/mesh.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Triangle mesh (host-side, numpy SoA).

Capability parity with the Metal reference's src/core/mesh.{hpp,cpp}: positions,
per-vertex shading data (normal, tangent w/ handedness, UV), u32 triangle
indices, and a per-triangle material-slot index. Tangents are generated when
absent with the mikktspace algorithm over *indexed* vertices exactly like the
reference (mesh.cpp:135-157 — which documents the indexed-data inaccuracy;
see core/mikkt.py, oracle-tested against the reference's C implementation).
UV-less meshes fall back to Lengyel accumulation for a usable frame.

Arrays stay numpy here; the render flattener concatenates meshes into device
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

F = np.float32
U = np.uint32


@dataclass
class Mesh:
    positions: np.ndarray                 # (V, 3) f32
    indices: np.ndarray                   # (T, 3) u32
    normals: np.ndarray | None = None     # (V, 3) f32
    tangents: np.ndarray | None = None    # (V, 4) f32, w = handedness
    uvs: np.ndarray | None = None         # (V, 2) f32
    material_slots: np.ndarray | None = None  # (T,) u32, slot per triangle
    name: str = "mesh"

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=F).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, dtype=U).reshape(-1, 3)
        v, t = len(self.positions), len(self.indices)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)
        else:
            self.normals = np.ascontiguousarray(self.normals, dtype=F).reshape(v, 3)
        if self.uvs is None:
            self.uvs = np.zeros((v, 2), dtype=F)
        else:
            self.uvs = np.ascontiguousarray(self.uvs, dtype=F).reshape(v, 2)
        if self.tangents is None:
            if np.any(self.uvs):
                # mikktspace over indexed vertices, like the reference
                # (mesh.cpp:135-157); exact-match tested vs the C oracle
                from platinum_tpu_torch.core.mikkt import generate_tangents_mikkt

                self.tangents = generate_tangents_mikkt(
                    self.positions, self.normals, self.uvs, self.indices
                )
            else:
                # no UV chart: mikktspace would emit its (1,0,0) default
                # everywhere; build any perpendicular frame instead
                self.tangents = generate_tangents(
                    self.positions, self.normals, self.uvs, self.indices
                )
        else:
            self.tangents = np.ascontiguousarray(self.tangents, dtype=F).reshape(v, 4)
        if self.material_slots is None:
            self.material_slots = np.zeros(t, dtype=U)
        else:
            self.material_slots = np.ascontiguousarray(
                self.material_slots, dtype=U
            ).reshape(t)

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.indices)

    @property
    def num_material_slots(self) -> int:
        return int(self.material_slots.max()) + 1 if len(self.material_slots) else 1

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return self.positions.min(axis=0), self.positions.max(axis=0)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted (unnormalized)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    lens[lens == 0] = 1.0
    return (normals / lens).astype(F)


def generate_tangents(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (Lengyel), accumulated over
    incident triangles then orthogonalized against the normal. Returns
    (V, 4) with w = handedness sign (+1/-1)."""
    v = len(positions)
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    du1 = uvs[i1] - uvs[i0]
    du2 = uvs[i2] - uvs[i0]

    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    safe = np.where(np.abs(det) < 1e-12, 1.0, det)
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / safe)[:, None]

    t_acc = np.zeros((v, 3), dtype=np.float64)
    b_acc = np.zeros((v, 3), dtype=np.float64)
    tri_t = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r
    tri_b = (e2 * du1[:, 0:1] - e1 * du2[:, 0:1]) * r
    for k in (i0, i1, i2):
        np.add.at(t_acc, k, tri_t)
        np.add.at(b_acc, k, tri_b)

    n = normals.astype(np.float64)
    t = t_acc - n * np.sum(n * t_acc, axis=-1, keepdims=True)
    lens = np.linalg.norm(t, axis=-1, keepdims=True)

    # Degenerate (no UVs / zero tangent): build any frame perpendicular to n
    bad = (lens < 1e-10)[:, 0]
    if bad.any():
        alt = np.where(
            np.abs(n[bad, 1:2]) < 0.9,
            np.cross(n[bad], np.array([0.0, 1.0, 0.0])),
            np.cross(n[bad], np.array([1.0, 0.0, 0.0])),
        )
        t[bad] = alt
        lens = np.linalg.norm(t, axis=-1, keepdims=True)

    t = t / np.maximum(lens, 1e-20)
    handed = np.where(np.sum(np.cross(n, t) * b_acc, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, handed[:, None]], axis=-1).astype(F)
