"""Geometry sharding: a partitioned scene spread across the ranks of a mesh.

Port of platinum_tpu/parallel/geometry.py. The single-device path
(accel/partition.py) traces a scene's partitions one after the other with
the best t carried. On a mesh with a "geom" axis each rank keeps
k = ceil(P / n_geom) of the partitions and traces the (replicated) ray
wave against those alone; the per-rank best hits are gathered over the
axis and folded in rank order with the strict `<`, and the few rays whose
ranks' bests nearly tie are traced again in rank order, which reproduces
the sequential path bit for bit (`make_local_geom_tracers`). Any hit is
an all-reduce of the occlusion bits.

Composes with the "sample" and "tile" ray axes of parallel/shard.py: rays
shard over "tile", geometry over "geom". Shading is replicated across the
geom axis, so every geom rank of a tile must trace the same wave bit for
bit: the shading path may hold no non-deterministic operation (an
`index_add_` with repeated indices on the card, an unstable sort), or
the gathered hits would describe different rays.

Partition tuples are FlatScene.wbvh_parts' (render/flatten.py):
(nodes, tris, meta, slot, worder[, inst_feat, inst_map]); the octant
orders are not used on this path, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from platinum_tpu_torch.ops.intersect import INF, HitRecord
from platinum_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                              all_reduce_mean, all_reduce_sum)


def _pad_to(a, n, fill):
    """`a` padded with `fill` to length n on axis 0."""
    if a.shape[0] == n:
        return a
    pad = torch.full((n - a.shape[0],) + tuple(a.shape[1:]), fill,
                     dtype=a.dtype, device=a.device)
    return torch.cat([a, pad])


def stack_partitions(part_arrays, n_shards: int):
    """Every partition padded to common shapes and stacked, the leading
    axis padded to a multiple of n_shards; returns (dict of stacked
    tensors, k partitions a shard).

    Padding is invisible to traversal: extra node rows and triangle
    blocks are unreachable (no child meta points at them), padded slot
    map entries are -1 (no triangle), and a pad partition is a single
    root whose 16 child slots are all empty (component 6 = -1, inverted
    bounds), so the walk pops the root, expands nothing and retires."""
    parts = [tuple(p) for p in part_arrays]
    instanced = any(len(p) > 6 for p in parts)
    k = math.ceil(len(parts) / n_shards)
    total = n_shards * k
    dev = parts[0][0].device

    n_nodes = max(int(p[0].shape[0]) for p in parts)
    n_blocks = max(int(p[1].shape[0]) for p in parts)
    n_inst = max((int(p[5].shape[0]) for p in parts if len(p) > 6),
                 default=0)

    cols = {key: [] for key in ("nodes", "meta", "tris", "slot")}
    if instanced:
        cols.update(inst_feat=[], inst_map=[])
    for p in parts:
        cols["nodes"].append(_pad_to(p[0].float(), n_nodes, 0.0))
        cols["meta"].append(_pad_to(p[2].int(), n_nodes * 16, -1))
        cols["tris"].append(_pad_to(p[1].float(), n_blocks, 0.0))
        cols["slot"].append(_pad_to(p[3].int(), n_blocks * 64, -1))
        if instanced:
            cols["inst_feat"].append(_pad_to(p[5].float(), n_inst, 0.0))
            cols["inst_map"].append(_pad_to(p[6].int(), n_inst, 0))
    empty = torch.zeros((1, 128), device=dev)
    empty[0, 6::8] = -1.0             # component 6 of every child: empty
    empty[0, 0::8] = 1e30             # inverted placeholder bounds
    empty[0, 3::8] = -1e30
    for _ in range(total - len(parts)):
        cols["nodes"].append(_pad_to(empty, n_nodes, 0.0))
        cols["meta"].append(torch.full((n_nodes * 16,), -1,
                                       dtype=torch.int32, device=dev))
        cols["tris"].append(torch.zeros((n_blocks, 10, 256), device=dev))
        cols["slot"].append(torch.full((n_blocks * 64,), -1,
                                       dtype=torch.int32, device=dev))
        if instanced:
            cols["inst_feat"].append(torch.zeros((n_inst, 10, 128),
                                                 device=dev))
            cols["inst_map"].append(torch.zeros((n_inst,), dtype=torch.int32,
                                                device=dev))
    return {key: torch.stack(v) for key, v in cols.items()}, k


def local_shard(stacked: dict, k: int, mesh: Mesh, axis: str = "geom"):
    """This rank's k partitions of the stacked table."""
    g = mesh.coords.get(axis, 0)
    return {key: v[g * k:(g + 1) * k] for key, v in stacked.items()}


# Two ranks' best hits closer than this (relative t) may be ordered one
# way by the float `<` of the merge and the other by the kernel's
# accept test against a carried tmax, which compares ts < tmax * |det|
# (csrc/mt_block.cuh), not t < tmax: such rays are traced again in rank
# order from the exact carried tmax. 1e-5 is ~80 float32 ulps.
TIE_REL = 1e-5


def _lanes(x, idx, r):
    """x[idx] for a per-ray (r,) tensor; a scalar or None as it is."""
    if isinstance(x, torch.Tensor) and x.dim() == 1 and x.shape[0] == r:
        return x[idx]
    return x


def make_local_geom_tracers(shard: dict, k: int, mesh: Mesh,
                            axis: str = "geom",
                            mt_precision: str = "highest"):
    """(trace_closest, trace_any) over this rank's k partitions (`shard`,
    see `local_shard`), merged over `axis` into the sequential tracer's
    result (accel/partition.py), bit for bit.

    Closest hit: every rank folds its own partitions with the best t
    carried, starting from the wave's tmax; the ranks' bests are gathered
    and folded in rank order with the strict `<` (the earlier partition
    keeps an exact tie). That is the sequential fold except where a later
    rank's best lies within TIE_REL of the earlier ranks': there the
    sequential tracer would have traced it under the carried tmax, whose
    accept test can reject a hit a float compare keeps. Those rays (a few
    in 10^5 on a bistro bounce wave) are traced again, rank after rank,
    each from the exact carried best. The float columns (t, u, v) and the
    integer columns (tri, hit[, inst]) are gathered apart: ids must never
    round-trip through float32 (ids >= 2^24 would round).

    Any hit ORs the local partitions, then all-reduces the bits. Every
    rank of the axis line must call the tracers the same number of times,
    on the same wave."""
    from platinum_tpu_torch.ops.intersect import fold_partition_tracers
    from platinum_tpu_torch.ops.packet_trace import make_packet_tracer

    instanced = "inst_feat" in shard
    pairs = [make_packet_tracer(
        shard["nodes"][i], shard["tris"][i], shard["meta"][i],
        shard["slot"][i],
        inst_feat=(shard["inst_feat"][i] if instanced else None),
        mt_precision=mt_precision) for i in range(k)]
    closest = [tc for tc, _ in pairs]
    inst_maps = [shard["inst_map"][i] if instanced else None
                 for i in range(k)]

    me = mesh.coords.get(axis, 0)

    def gathered(o, d, tmin, tmax, active, trace=True):
        """This rank's carried fold from `tmax`, gathered over the axis:
        (n, r, 3) float columns, (n, r, 2|3) integer columns. A rank
        that does not `trace` sends a miss of the same shape, so the
        collectives still pair up."""
        r = o.shape[0]
        if not trace:
            fcols = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
            icols = torch.zeros((r, 3 if instanced else 2),
                                dtype=torch.int32, device=o.device)
            return (all_gather(fcols, mesh, axis),
                    all_gather(icols, mesh, axis))
        best = fold_partition_tracers(closest, inst_maps, o, d, tmin, tmax,
                                      active=active, instanced=instanced)
        icols = [best.tri, best.hit.to(torch.int32)]
        if instanced:
            icols.append(best.inst)
        return (all_gather(torch.stack([best.t, best.bary[:, 0],
                                        best.bary[:, 1]], -1), mesh, axis),
                all_gather(torch.stack(icols, -1), mesh, axis))

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        allf, alli = gathered(o, d, tmin, tmax, active)
        mf, mi = allf[0], alli[0]
        near = torch.zeros_like(mi[:, 1], dtype=torch.bool)
        for g in range(1, allf.shape[0]):
            hit_g, t_g = alli[g, :, 1] > 0, allf[g, :, 0]
            near |= (hit_g & (mi[:, 1] > 0)
                     & ((t_g - mf[:, 0]).abs() <= TIE_REL * mf[:, 0]))
            closer = hit_g & (t_g < mf[:, 0])
            mf = torch.where(closer[:, None], allf[g], mf)
            mi = torch.where(closer[:, None], alli[g], mi)
        # the count is read on the host (one sync a wave): every rank of
        # the line must agree on whether, and on how many rays, to retrace
        idx = torch.nonzero(near).squeeze(1)
        trace_closest.retraced += len(idx)
        if len(idx):            # the same rays on every rank of the line
            r = o.shape[0]
            sf, si = allf[0][idx], alli[0][idx]     # rank 0's is exact
            sub = [_lanes(x, idx, r) for x in (tmin, active)]
            for g in range(1, allf.shape[0]):
                # rank g alone folds its partitions from the exact carried
                # best (a hit there is closer by construction); the others
                # send misses so that the gather pairs up
                gf, gi = gathered(o[idx], d[idx], sub[0], sf[:, 0], sub[1],
                                  trace=(me == g))
                take = gi[g, :, 1] > 0
                sf = torch.where(take[:, None], gf[g], sf)
                si = torch.where(take[:, None], gi[g], si)
            mf = mf.index_copy(0, idx, sf)
            mi = mi.index_copy(0, idx, si)
        hit = mi[:, 1] > 0
        return HitRecord(t=torch.where(hit, mf[:, 0], INF), tri=mi[:, 0],
                         bary=mf[:, 1:], hit=hit,
                         inst=(mi[:, 2] if instanced else None))

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        for _, ta in pairs:
            live = (active & ~occ) if active is not None else ~occ
            occ = occ | ta(o, d, tmin, tmax, active=live)
        return all_reduce_sum(occ.to(torch.int32), mesh, axis) > 0

    trace_closest.retraced = 0      # rays traced again in rank order
    return trace_closest, trace_any


def make_geom_sharded_tracer(part_arrays, mesh: Mesh, axis: str = "geom",
                             mt_precision: str = "highest"):
    """(trace_closest, trace_any) over partitions spread along `axis`: the
    signature of accel/partition.make_partitioned_tracer, with the ray
    inputs and outputs replicated over the axis (every rank of the line
    computes the same merged record)."""
    stacked, k = stack_partitions(part_arrays, mesh.shape[axis])
    return make_local_geom_tracers(local_shard(stacked, k, mesh, axis), k,
                                   mesh, axis, mt_precision=mt_precision)


def make_geom_sharded_step(flat, settings, mesh: Mesh,
                           features: frozenset | None = None):
    """The progressive step with three axes: rays over "sample" x "tile"
    (parallel/shard.py's semantics), geometry over "geom". Each rank
    traces its tile's rays against its own partitions, hits merge over
    "geom" inside the bounce loop, and shading is replicated across it.
    Returns step(accum, step_idx) -> accum, this rank's (P/T, 3)
    accumulator advanced by S = mesh.shape["sample"] samples."""
    from platinum_tpu_torch.models import bsdf as _bsdf
    from platinum_tpu_torch.parallel.shard import _shard
    from platinum_tpu_torch.render.integrator import render_sample

    if flat.wbvh_parts is None:
        raise ValueError("geometry sharding needs a partitioned scene "
                         "(FlatScene.wbvh_parts)")
    missing = {"geom", "sample", "tile"} - set(mesh.shape)
    if missing:
        raise ValueError(f"mesh must name axes geom/sample/tile "
                         f"(missing {sorted(missing)}); use size-1 axes "
                         f"for dimensions you don't shard")
    n_sample, s, pixel_ids = _shard(settings, mesh,
                                    flat.camera.position.device)
    feats = features if features is not None else _bsdf.ALL_FEATURES
    stacked, k = stack_partitions(flat.wbvh_parts, mesh.shape["geom"])
    tracers = make_local_geom_tracers(local_shard(stacked, k, mesh), k, mesh,
                                      mt_precision=settings.mt_precision)
    flat_rep = dataclasses.replace(flat, wbvh_parts=None)

    def step(accum, step_idx: int):
        radiance = render_sample(flat_rep, settings, step_idx * n_sample + s,
                                 pixel_ids=pixel_ids, tracers=tracers,
                                 features=feats)
        radiance = all_reduce_mean(radiance, mesh, "sample")
        kk = float(step_idx)
        return (accum * kk + radiance) / (kk + 1.0)

    return step


def render_geom_sharded(flat, settings, mesh: Mesh,
                        features: frozenset | None = None,
                        steps: int | None = None) -> torch.Tensor:
    """Render settings.spp samples with geometry and ray sharding; returns
    (H, W, 3) on every rank (parallel/shard.py's render_sharded for
    partitioned scenes)."""
    from platinum_tpu_torch.parallel.shard import gather_image

    n_sample = mesh.shape.get("sample", 1)
    steps = steps if steps is not None else -(-settings.spp // n_sample)
    step = make_geom_sharded_step(flat, settings, mesh, features=features)
    accum = torch.zeros((settings.num_pixels // mesh.shape["tile"], 3),
                        device=flat.camera.position.device)
    for i in range(steps):
        accum = step(accum, i)
    return gather_image(accum, settings, mesh)
