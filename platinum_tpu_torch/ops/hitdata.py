"""Hit-point shading data interpolation.

Port of `interpolate_hit` (platinum_tpu/ops/hitdata.py:47): barycentric
interpolation of normals and UVs, the geometric normal from the edge cross
product, the shading frame from normal + tangent (+ handedness), and the
outgoing direction in it. Geometry is world space (instances baked), or on
the two-level path an object-space mesh library: then `instances` gives
each lane its instance's linear part A and normal matrix, and the
material slot of the library row resolves through the per-(instance,
slot) table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from platinum_tpu_torch.ops import frame as frame_ops
from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops.intersect import HitRecord
from platinum_tpu_torch.render.types import Geometry


@dataclass(frozen=True)
class HitData:
    pos: torch.Tensor       # (R, 3) world hit position
    normal: torch.Tensor    # (R, 3) shading normal
    gnormal: torch.Tensor   # (R, 3) geometric normal
    uv: torch.Tensor        # (R, 2)
    wo: torch.Tensor        # (R, 3) outgoing direction, local frame
    frame_t: torch.Tensor   # (R, 3)
    frame_b: torch.Tensor   # (R, 3)
    mat_idx: torch.Tensor   # (R,) i32

    @property
    def frame(self):
        return self.frame_t, self.frame_b, self.normal


def interpolate_hit(geometry: Geometry, rec: HitRecord, o: torch.Tensor,
                    d: torch.Tensor, instances=None) -> HitData:
    tri = torch.where(rec.hit, rec.tri, 0)   # safe index on misses
    u = rec.bary[..., 0:1]
    v = rec.bary[..., 1:2]
    w = 1.0 - u - v

    shade = lookup.rows(geometry.tri_shade, tri)   # (R, 24)
    geo = lookup.rows(geometry.tri_geo, tri)       # (R, 12)

    n0, n1, n2 = shade[..., 0:3], shade[..., 3:6], shade[..., 6:9]
    tangent4 = shade[..., 9:13]
    uv = shade[..., 13:15] * w + shade[..., 15:17] * u + shade[..., 17:19] * v

    normal = frame_ops.normalize(n0 * w + n1 * u + n2 * v)
    tangent = frame_ops.normalize(tangent4[..., :3])
    sign = tangent4[..., 3]
    gnormal = frame_ops.normalize(frame_ops.cross(geo[..., 3:6], geo[..., 6:9]))
    mat_idx = geo[..., 9].to(torch.int32)   # value float, see flatten

    if instances is not None and rec.inst is not None:
        inst = torch.where(rec.hit, rec.inst, 0)
        irow = lookup.rows(instances.rows, inst)       # (R, 24)
        a = irow[..., 0:9].reshape(-1, 3, 3)
        nm = irow[..., 9:18].reshape(-1, 3, 3)

        def xf(m, v):
            return torch.einsum("rij,rj->ri", m, v)

        normal = frame_ops.normalize(xf(nm, normal))
        gnormal = frame_ops.normalize(xf(nm, gnormal))
        tangent = frame_ops.normalize(xf(a, tangent))
        # the library row holds the material SLOT
        n_slots = instances.slot_mat.shape[1]
        flat_ids = inst * n_slots + torch.clamp(mat_idx, 0, n_slots - 1)
        mat_idx = lookup.rows(instances.slot_mat.reshape(-1, 1),
                              flat_ids)[..., 0].to(torch.int32)

    t = torch.where(rec.hit, rec.t, 0.0)
    # XLA fuses o + d * t into one multiply-add: formed in float64 (the
    # product of two float32 values is exact there) and rounded once, the
    # hit point is the JAX package's, and so are the coplanar ties that
    # its 1-ulp differences would otherwise break the other way
    pos = (o.double() + d.double() * t.double()[..., None]).float()
    fr = frame_ops.from_nt(normal, tangent, sign)
    wo = frame_ops.world_to_local(fr, -d)
    return HitData(pos=pos, normal=fr[2], gnormal=gnormal, uv=uv, wo=wo,
                   frame_t=fr[0], frame_b=fr[1], mat_idx=mat_idx)
