"""Copy of platinum_tpu/core/primitives.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Procedural primitive meshes.

Parity with the Metal reference's src/core/primitives.cpp: plane, cube, UV sphere,
and a 5-wall Cornell box with a near-ceiling light panel and 4 material slots
(0 = walls/floor/ceiling, 1 = right wall, 2 = left wall, 3 = light). Geometry
conventions match the reference (Y-up, CCW winding as seen from the normal
side, Cornell box interior normals, box spans y ∈ [0, 10]).
"""

from __future__ import annotations

import numpy as np

from platinum_tpu_torch.core.mesh import Mesh

F = np.float32


def plane(side: float = 1.0) -> Mesh:
    h = side * 0.5
    positions = np.array(
        [[-h, 0, -h], [h, 0, -h], [-h, 0, h], [h, 0, h]], dtype=F
    )
    normals = np.tile([0, 1, 0], (4, 1)).astype(F)
    tangents = np.tile([1, 0, 0, 1], (4, 1)).astype(F)
    uvs = ((positions[:, [0, 2]] + h) / (2 * h)).astype(F)
    indices = np.array([[0, 2, 1], [1, 2, 3]], dtype=np.uint32)
    return Mesh(positions, indices, normals, tangents, uvs, name="plane")


def _box_faces(face_normals, h: float, invert: bool = False, offset=(0, 0, 0)):
    """Quad faces for an axis-aligned box; returns (pos, nrm, tan, uv, idx)."""
    face_uv = np.array([[1, -1], [1, 1], [-1, -1], [-1, 1]], dtype=F)
    pos, nrm, tan, uv, idx = [], [], [], [], []
    for i, fn in enumerate(face_normals):
        fn = np.asarray(fn, dtype=F)
        up = np.array([1, 0, 0], F) if abs(fn[1]) == 1.0 else np.array([0, 1, 0], F)
        right = np.cross(up, fn)
        sign = -1.0 if invert else 1.0
        for fp in face_uv:
            p = (sign * fn + up * fp[0] + right * fp[1]) * h + np.asarray(offset, F)
            pos.append(p)
            nrm.append(fn)
            tan.append([*right, 1.0])
            uv.append(fp)
        b = 4 * i
        idx += [[b + 0, b + 2, b + 1], [b + 1, b + 2, b + 3]]
    return (
        np.array(pos, F),
        np.array(nrm, F),
        np.array(tan, F),
        np.array(uv, F),
        np.array(idx, np.uint32),
    )


def cube(side: float = 1.0) -> Mesh:
    normals6 = [(0, 0, 1), (1, 0, 0), (0, 0, -1), (-1, 0, 0), (0, 1, 0), (0, -1, 0)]
    pos, nrm, tan, uv, idx = _box_faces(normals6, side * 0.5)
    return Mesh(pos, idx, nrm, tan, uv, name="cube")


def sphere(radius: float = 1.0, lat: int = 24, lng: int = 32) -> Mesh:
    i = np.arange(lat + 1)
    j = np.arange(lng + 1)
    phi = 0.5 * np.pi - i * (np.pi / lat)          # +pi/2 (top) → -pi/2
    theta = j * (2.0 * np.pi / lng)
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)

    # Unit sphere directions, grid (lat+1, lng+1)
    d = np.stack(
        [cp[:, None] * ct[None, :],
         np.broadcast_to(sp[:, None], (lat + 1, lng + 1)),
         cp[:, None] * st[None, :]],
        axis=-1,
    ).astype(F)
    positions = (d * radius).reshape(-1, 3)
    normals = d.reshape(-1, 3)
    tangents = np.stack(
        [np.broadcast_to(-st[None, :], (lat + 1, lng + 1)),
         np.zeros((lat + 1, lng + 1), F),
         np.broadcast_to(ct[None, :], (lat + 1, lng + 1)),
         np.ones((lat + 1, lng + 1), F)],
        axis=-1,
    ).reshape(-1, 4).astype(F)
    uvs = np.stack(
        np.meshgrid(j / lng, i / lat, indexing="xy"), axis=-1
    ).reshape(-1, 2).astype(F)

    # Triangulate the grid
    ii, jj = np.meshgrid(np.arange(1, lat + 1), np.arange(1, lng + 1), indexing="ij")
    v0 = (ii - 1) * (lng + 1) + (jj - 1)
    v1 = (ii - 1) * (lng + 1) + jj
    v2 = ii * (lng + 1) + (jj - 1)
    v3 = ii * (lng + 1) + jj
    tris = np.stack(
        [np.stack([v0, v1, v2], -1), np.stack([v1, v3, v2], -1)], axis=2
    ).reshape(-1, 3).astype(np.uint32)
    return Mesh(positions, tris, normals, tangents, uvs, name="sphere")


def cornell_box(half: float = 5.0) -> Mesh:
    """Open-front Cornell box, interior normals, plus a light quad just under
    the ceiling. Material slots: 0 = back/floor/ceiling, 1 = right wall (+x
    normal, i.e. the wall on -x side), 2 = left wall, 3 = light."""
    normals5 = [(0, 0, 1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)]
    pos, nrm, tan, uv, idx = _box_faces(
        normals5, half, invert=True, offset=(0, half, 0)
    )
    slots = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2], dtype=np.uint32)

    # Light panel, 2x2 units, just below the ceiling, facing down
    face_uv = np.array([[1, -1], [1, 1], [-1, -1], [-1, 1]], dtype=F)
    lp = np.array([[fp[0], 2 * half - 0.01, fp[1]] for fp in face_uv], dtype=F)
    ln = np.tile([0, -1, 0], (4, 1)).astype(F)
    lt = np.tile([0, 0, 1, 1], (4, 1)).astype(F)
    b = len(pos)
    lidx = np.array([[b, b + 2, b + 1], [b + 1, b + 2, b + 3]], dtype=np.uint32)

    return Mesh(
        np.concatenate([pos, lp]),
        np.concatenate([idx, lidx]),
        np.concatenate([nrm, ln]),
        np.concatenate([tan, lt]),
        np.concatenate([uv, face_uv]),
        material_slots=np.concatenate([slots, [3, 3]]).astype(np.uint32),
        name="cornell_box",
    )
