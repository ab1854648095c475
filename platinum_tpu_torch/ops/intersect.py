"""Ray-triangle intersection: hit records and the brute-force tracer.

Port of platinum_tpu/ops/intersect.py: `HitRecord`, `fold_closest` and
`fold_partition_tracers` (the partition tracers' shared fold), the
vectorised Möller-Trumbore test and `make_brute_tracer` (every ray against
every triangle in chunks; the tracer scenes below `accel_min_tris` use,
Cornell among them, and the correctness oracle of the packet tracer).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from platinum_tpu_torch.ops.frame import cross, dot
from platinum_tpu_torch.render.types import Geometry

INF = float("inf")
DET_EPS = 1e-12


@dataclass(frozen=True)
class HitRecord:
    t: torch.Tensor      # (R,) distance, inf on miss
    tri: torch.Tensor    # (R,) i32 triangle index, -1 on miss
    bary: torch.Tensor   # (R, 2) barycentric (u, v) for vertices 1, 2
    hit: torch.Tensor    # (R,) bool
    # (R,) i32 instance id, set only by the two-level (TLAS/BLAS) tracer;
    # None for world-space baked geometry
    inst: torch.Tensor | None = None


def fold_closest(best: HitRecord, rec: HitRecord,
                 inst_override=None) -> HitRecord:
    """Carried-best-t fold shared by every sequential partition tracer
    (accel/partition.py, parallel/geometry.py): strict `<` keeps the
    earlier record on exact ties, the tie-breaking the bit-exact tests
    pin. `inst_override` stands in for rec.inst (partition-local instance
    ids remapped to global ones)."""
    closer = rec.hit & (rec.t < best.t)
    inst = best.inst
    if best.inst is not None:
        src = inst_override if inst_override is not None else rec.inst
        inst = torch.where(closer, src, best.inst)
    return HitRecord(
        t=torch.where(closer, rec.t, best.t),
        tri=torch.where(closer, rec.tri, best.tri),
        bary=torch.where(closer[:, None], rec.bary, best.bary),
        hit=best.hit | closer,
        inst=inst,
    )


def fold_partition_tracers(tracers, inst_maps, o, d, tmin, tmax,
                           active=None, instanced=False) -> HitRecord:
    """Carried-best-t fold over a list of partition tracers: the one inner
    loop of accel/partition.py's sequential tracer and of
    parallel/geometry.py's per-rank shard, so their tie-breaking cannot
    drift. Each tracer is culled by the running best t; partition-local
    instance ids are clipped and remapped through the matching `inst_maps`
    entry (None: no remap). Returns the raw fold: best.t still carries
    tmax on a miss (callers apply INF, or merge across ranks first)."""
    r = o.shape[0]
    dev = o.device
    best = HitRecord(
        t=torch.as_tensor(tmax, dtype=torch.float32, device=dev)
        .expand(r).clone(),
        tri=torch.full((r,), -1, dtype=torch.int32, device=dev),
        bary=torch.zeros((r, 2), device=dev),
        hit=torch.zeros((r,), dtype=torch.bool, device=dev),
        inst=(torch.zeros((r,), dtype=torch.int32, device=dev)
              if instanced else None),
    )
    for tc, imap in zip(tracers, inst_maps):
        rec = tc(o, d, tmin, best.t, active=active)
        override = None
        if imap is not None:
            local = torch.clamp(rec.inst, 0, imap.shape[0] - 1).long()
            override = imap[local].to(torch.int32)
        best = fold_closest(best, rec, inst_override=override)
    return best


def _moller_trumbore(o, d, v0, e1, e2, tmin, tmax):
    """o, d: (R, 1, 3); v0/e1/e2: (1, C, 3). Returns t, u, v, valid (R, C)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, u, v, valid


def _chunk_triangles(geometry: Geometry, chunk: int):
    """(nc, C, 3) chunks of (v0, e1, e2); zero triangles pad the last."""
    idx = geometry.indices.long()
    p = geometry.positions
    v0 = p[idx[:, 0]]
    e1 = p[idx[:, 1]] - v0
    e2 = p[idx[:, 2]] - v0
    n_pad = (-v0.shape[0]) % chunk
    if n_pad:
        pad = torch.zeros((n_pad, 3), dtype=v0.dtype, device=v0.device)
        v0, e1, e2 = (torch.cat([x, pad]) for x in (v0, e1, e2))
    shape = (-1, chunk, 3)
    return v0.reshape(shape), e1.reshape(shape), e2.reshape(shape)


def _ray_bounds(o, tmin, tmax, active):
    r = o.shape[0]
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=o.device)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device)
    if active is not None:
        tmax = torch.where(active, tmax, tmin)
    return tmin.expand(r), tmax.expand(r)


def make_brute_tracer(geometry: Geometry, chunk: int = 256):
    """(trace_closest, trace_any) closures over chunked triangles.

    trace_closest(o, d, tmin, tmax, active=None) -> HitRecord
    trace_any(o, d, tmin, tmax, active=None)     -> (R,) bool occlusion
    """
    n_tris = int(geometry.indices.shape[0])
    chunk = min(chunk, max(8, 1 << (n_tris - 1).bit_length()))
    v0c, e1c, e2c = _chunk_triangles(geometry, chunk)

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        r = o.shape[0]
        tmin, tmax = _ray_bounds(o, tmin, tmax, active)
        o_b, d_b = o[:, None, :], d[:, None, :]
        best_t = torch.full((r,), INF, device=o.device)
        best_tri = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        best_u = torch.zeros((r,), device=o.device)
        best_v = torch.zeros((r,), device=o.device)
        for c in range(v0c.shape[0]):
            t, u, v, valid = _moller_trumbore(
                o_b, d_b, v0c[c][None], e1c[c][None], e2c[c][None],
                tmin[:, None], torch.minimum(tmax, best_t)[:, None])
            t = torch.where(valid, t, INF)
            # first column holding the chunk's minimum (ties -> lowest id)
            cand_t, cand_j = torch.min(t, dim=-1)
            rows = torch.arange(r, device=o.device)
            better = cand_t < best_t
            best_tri = torch.where(better, (c * chunk + cand_j).int(), best_tri)
            best_u = torch.where(better, u[rows, cand_j], best_u)
            best_v = torch.where(better, v[rows, cand_j], best_v)
            best_t = torch.where(better, cand_t, best_t)
        return HitRecord(t=best_t, tri=best_tri,
                         bary=torch.stack([best_u, best_v], -1),
                         hit=torch.isfinite(best_t))

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        tmin, tmax = _ray_bounds(o, tmin, tmax, active)
        o_b, d_b = o[:, None, :], d[:, None, :]
        occluded = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        for c in range(v0c.shape[0]):
            _, _, _, valid = _moller_trumbore(
                o_b, d_b, v0c[c][None], e1c[c][None], e2c[c][None],
                tmin[:, None], tmax[:, None])
            occluded = occluded | valid.any(dim=-1)
        return occluded

    return trace_closest, trace_any
