"""Hit-point shading data interpolation.

Port of `interpolate_hit` (platinum_tpu/ops/hitdata.py:47): barycentric
interpolation of normals and UVs, the geometric normal from the edge cross
product, the shading frame from normal + tangent (+ handedness), and the
outgoing direction in it. Geometry is world space (instances baked), or on
the two-level path an object-space mesh library: then `instances` gives
each lane its instance's linear part A and normal matrix, and the
material slot of the library row resolves through the per-(instance,
slot) table.

`fetch_hit` is the shaded bounce's hit fetch: `interpolate_hit` and the
material rows `make_shading_context` reads (models/bsdf.py), as
`HitData` and `HitRows`. On CUDA tensors it launches the hand-written
kernel of csrc/hit_fetch.cu (one thread a lane; on the two-level path
with the instance transform) or raises; on CPU tensors it runs the plain
code. `LAUNCHES` counts the launches; counter `hitfetch.kernel_lanes`
the lanes they fetched and `hitfetch.lanes` the lanes `fetch_hit` was
given.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from platinum_tpu_torch.ops import frame as frame_ops
from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops.intersect import HitRecord
from platinum_tpu_torch.render.types import Geometry, MaterialTable
from platinum_tpu_torch.utils import telemetry


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


@dataclass(frozen=True)
class HitRows:
    """The hit material's rows, per lane: what `make_shading_context`
    reads of the material table."""

    mat: torch.Tensor                        # (R, 16) materials.packed
    energy_avg: torch.Tensor | None = None   # (R, 4) materials.energy_avg
    tex: torch.Tensor | None = None          # (R, 6) i32 materials.textures


def material_rows(materials: MaterialTable, mat_idx: torch.Tensor,
                  textures: bool) -> HitRows:
    """The plain row reads of the hit material; the atlas entries only
    where `textures` (the scene has an atlas)."""
    return HitRows(
        mat=lookup.rows(materials.packed, mat_idx),
        energy_avg=(lookup.rows(materials.energy_avg, mat_idx)
                    if materials.energy_avg is not None else None),
        tex=lookup.rows(materials.textures, mat_idx) if textures else None)


# Kernel launches, counted where the wrapper launches
LAUNCHES = {"hit_fetch": 0}


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hit_fetch_launch.restype = i
    lib.hit_fetch_launch.argtypes = [i, p, i, p]
    lib.hit_fetch_error_string.restype = ctypes.c_char_p
    lib.hit_fetch_error_string.argtypes = [i]


def _table(name, t, k, dev, dtype=torch.float32, align=16):
    if (t.device != dev or t.dtype != dtype or t.dim() != 2
            or t.shape[1] != k or not t.is_contiguous()
            or t.data_ptr() % align):
        raise ValueError(f"{name} must be a contiguous {dtype} (rows, {k}) "
                         f"table on {dev}, {align}-byte aligned")
    return t.data_ptr()


def _launch(geometry: Geometry, rec: HitRecord, o, d,
            materials: MaterialTable, textures: bool, instances=None):
    """One launch of csrc/hit_fetch.cu over the lanes of `d` (n, 3):
    (HitData, HitRows), with `instances` the two-level path's instance
    transform and material slots. Outputs are allocated here; the kernel
    allocates nothing and does not synchronise."""
    from platinum_tpu_torch.ops.packet_trace import lane_field, load_library

    dev = d.device
    if d.dim() != 2:
        raise ValueError(f"d must be (n, 3), got {tuple(d.shape)}")
    n = d.shape[0]
    words = (lane_field("tri", rec.tri, n, 1, dev, torch.int32)
             + lane_field("hit", rec.hit, n, 1, dev, torch.bool)
             + lane_field("t", rec.t, n, 1, dev)
             + lane_field("bary", rec.bary, n, 2, dev)
             + lane_field("o", o, n, 3, dev)
             + lane_field("d", d, n, 3, dev))
    two_level = instances is not None and rec.inst is not None
    words += (lane_field("inst", rec.inst, n, 1, dev, torch.int32)
              if two_level else [0, 0, 0])
    avg = materials.energy_avg
    words += [_table("tri_shade", geometry.tri_shade, 24, dev),
              _table("tri_geo", geometry.tri_geo, 12, dev),
              _table("materials.packed", materials.packed, 16, dev),
              _table("materials.energy_avg", avg, 4, dev)
              if avg is not None else 0,
              _table("materials.textures", materials.textures, 6, dev,
                     torch.int32, 8) if textures else 0]
    if two_level:
        slots = instances.slot_mat
        words += [_table("instances.rows", instances.rows, 24, dev),
                  _table("instances.slot_mat", slots, slots.shape[-1], dev,
                         align=4),
                  slots.shape[-1]]
    else:
        words += [0, 0, 0]

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    hd = HitData(pos=out(n, 3), normal=out(n, 3), gnormal=out(n, 3),
                 uv=out(n, 2), wo=out(n, 3), frame_t=out(n, 3),
                 frame_b=out(n, 3), mat_idx=out(n, dtype=torch.int32))
    rows = HitRows(mat=out(n, 16),
                   energy_avg=out(n, 4) if avg is not None else None,
                   tex=out(n, 6, dtype=torch.int32) if textures else None)
    words += [hd.pos.data_ptr(), hd.normal.data_ptr(), hd.gnormal.data_ptr(),
              hd.uv.data_ptr(), hd.wo.data_ptr(), hd.frame_t.data_ptr(),
              hd.frame_b.data_ptr(), hd.mat_idx.data_ptr(),
              rows.mat.data_ptr(),
              rows.energy_avg.data_ptr() if avg is not None else 0,
              rows.tex.data_ptr() if textures else 0]
    if n:
        lib = load_library("hit_fetch", _declare)
        args = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(dev):
            rc = lib.hit_fetch_launch(
                n, args, len(words),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                "hit_fetch launch failed: "
                f"{lib.hit_fetch_error_string(rc).decode()} ({rc})")
        LAUNCHES["hit_fetch"] += 1
        telemetry.count("hitfetch.kernel_lanes", n)
    return hd, rows


def fetch_hit(geometry: Geometry, rec: HitRecord, o: torch.Tensor,
              d: torch.Tensor, materials: MaterialTable,
              textures: bool = False, instances=None):
    """(HitData, HitRows) of each lane's hit: `interpolate_hit` and the
    rows of its material (`textures`: the atlas entries too). CUDA
    tensors launch the kernel (csrc/hit_fetch.cu) or raise; CPU tensors
    run the plain code. Every material index, as `lookup.rows` asks, lies
    in the material table: the kernel reads the row it names unchecked."""
    telemetry.count("hitfetch.lanes", d.shape[:-1].numel())
    if not d.is_cuda:
        hd = interpolate_hit(geometry, rec, o, d, instances=instances)
        return hd, material_rows(materials, hd.mat_idx, textures)
    return _launch(geometry, rec, o, d, materials, textures, instances)
