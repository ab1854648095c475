"""Copy of platinum_tpu/accel/partition.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package. `Partition` and `partition_bvh` are the
numpy host code as it stands there; `make_partitioned_tracer` is written in
torch over this package's packet tracer (ops/packet_trace.py), and the
budget comment speaks of the card's memory, not of VMEM.

Scene partitioning for beyond-budget geometry.

A scene over `partition_tris` triangles under `stream="off"` is split at
the top of the binary SAH tree into spatial subtrees that each fit, and a
wave is traced through the partitions sequentially with the running
best-t carried as tmax: later partitions are culled by earlier hits, so
the extra cost is roughly one root-level AABB rejection per
non-overlapping partition, not a full retraversal. Partitions are also
the unit that geometry sharding (parallel/geometry.py) spreads over
ranks.

Partitions reuse the standard one-level wide BVH + packet tracer
unchanged; triangle ids are globalized by each partition's base offset.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from platinum_tpu_torch.accel.bvh import BVH

F = np.float32

# Default per-partition budget: tri-block bytes ~ 160 B/tri + node rows,
# the JAX package's value (its VMEM budget), kept so that both packages
# cut the same scene into the same partitions.
DEFAULT_BUDGET_TRIS = 350_000


@dataclass
class Partition:
    bvh: BVH            # re-rooted standalone sub-BVH (local node/tri ids)
    tri_base: int       # first global (BVH-ordered) triangle id
    tri_count: int


def partition_bvh(bvh: BVH, budget_tris: int = DEFAULT_BUDGET_TRIS
                  ) -> list[Partition]:
    """Split `bvh` into root-subtree partitions of <= budget_tris each.

    DFS/skip layout property: subtree [i, skip[i]) owns the contiguous
    triangle range [csum[i], csum[skip[i]]), so every partition is a
    contiguous slice of both arrays.
    """
    n = bvh.num_nodes
    skip = bvh.skip.astype(np.int64)
    tri_count = bvh.tri_count.astype(np.int64)
    is_leaf = tri_count > 0
    csum = np.zeros(n + 1, np.int64)
    np.cumsum(tri_count, out=csum[1:])

    roots: list[int] = []
    stack = [0]
    while stack:
        i = stack.pop()
        sub = csum[skip[i]] - csum[i]
        if sub <= budget_tris or is_leaf[i]:
            roots.append(i)
        else:
            stack.append(int(skip[i + 1]))   # right child
            stack.append(i + 1)              # left child
    roots.sort()                             # global tri order

    parts = []
    for i in roots:
        j = int(skip[i])
        base = int(csum[i])
        count = int(csum[j] - base)
        if count == 0:
            continue
        sub_skip = (skip[i:j] - i).astype(np.int32)
        sub_start = np.where(
            tri_count[i:j] > 0, bvh.tri_start[i:j] - base, -1
        ).astype(np.int32)
        sub = BVH(
            bounds_lo=bvh.bounds_lo[i:j],
            bounds_hi=bvh.bounds_hi[i:j],
            skip=sub_skip,
            tri_start=sub_start,
            tri_count=tri_count[i:j].astype(np.int32),
            tri_order=np.arange(count, dtype=np.int64),
            max_leaf=bvh.max_leaf,
        )
        parts.append(Partition(bvh=sub, tri_base=base, tri_count=count))
    assert sum(p.tri_count for p in parts) == int(csum[n])
    return parts


def make_partitioned_tracer(part_arrays, oct_order=False,
                            mt_precision="highest"):
    """(trace_closest, trace_any) over a list of per-partition packed wide
    BVHs: [(nodes, tris, meta, slot_global, worder[, inst_feat,
    inst_map]), ...], one packet tracer pair each (K1/K2; K3 over
    instanced partitions; K7 under `oct_order`, from each tuple's
    `worder`). Closest hit traces the partitions in order, carrying the
    best hit so far as tmax (ops/intersect.py fold_partition_tracers);
    any hit ORs them, each launched only on the lanes still unoccluded.

    7-tuples are instanced partitions (accel/tlas.py
    partition_instanced): `inst_feat` feeds the kernel's per-instance
    feature transforms and the partition-local instance ids it reports
    are remapped through `inst_map` (local -> global), so shading keeps
    one global InstanceTable."""
    from platinum_tpu_torch.ops.intersect import (INF, HitRecord,
                                                  fold_partition_tracers)
    from platinum_tpu_torch.ops.packet_trace import make_packet_tracer

    pairs = [
        make_packet_tracer(p[0], p[1], p[2], p[3],
                           worder=(p[4] if oct_order and len(p) > 4
                                   and p[4] is not None else None),
                           inst_feat=(p[5] if len(p) > 6 else None),
                           mt_precision=mt_precision)
        for p in part_arrays
    ]
    closest_tracers = [p[0] for p in pairs]
    any_tracers = [p[1] for p in pairs]
    inst_maps = [p[6] if len(p) > 6 else None for p in part_arrays]
    instanced = any(m is not None for m in inst_maps)

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        best = fold_partition_tracers(closest_tracers, inst_maps, o, d,
                                      tmin, tmax, active=active,
                                      instanced=instanced)
        return HitRecord(
            t=torch.where(best.hit, best.t, INF),
            tri=best.tri, bary=best.bary, hit=best.hit, inst=best.inst)

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
        for ta in any_tracers:
            live = (active & ~occ) if active is not None else ~occ
            occ = occ | ta(o, d, tmin, tmax, active=live)
        return occ

    return trace_closest, trace_any
