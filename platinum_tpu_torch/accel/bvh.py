"""Copy of platinum_tpu/accel/bvh.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

BVH construction (host-side).

The reference delegates acceleration structures to Metal
(MTL::AccelerationStructure, renderer_pt.cpp:653-749); on TPU we build our
own. This module is the numpy reference builder — binned SAH (16 bins) with
a median-split fallback — emitting a *threaded* (skip-link) flat layout
shaped for data-parallel traversal on TPU:

  nodes are in DFS order;
  on AABB hit an inner node falls through to ptr+1;
  on miss (or after a leaf) traversal jumps to skip[ptr] (== num_nodes when
  the walk is done);
  leaf triangles are contiguous in a reordered triangle array.

A C++ builder with identical output lives in accel/cpp (used when available;
this module is the oracle and fallback).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32

_N_BINS = 16


@dataclass
class BVH:
    bounds_lo: np.ndarray   # (N, 3) f32
    bounds_hi: np.ndarray   # (N, 3) f32
    skip: np.ndarray        # (N,) i32 — jump target on miss / after a leaf
    tri_start: np.ndarray   # (N,) i32 — leaf range start into tri_order (-1 inner)
    tri_count: np.ndarray   # (N,) i32 — 0 for inner nodes
    tri_order: np.ndarray   # (T,) i64 — permutation of input triangles
    max_leaf: int

    @property
    def num_nodes(self) -> int:
        return len(self.skip)


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf: int = 4) -> BVH:
    """Binned-SAH BVH over triangles given by vertex arrays (T, 3)."""
    t = len(v0)
    lo = np.minimum(np.minimum(v0, v1), v2).astype(F)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(F)
    centroid = ((lo + hi) * 0.5).astype(F)

    n_lo, n_hi, n_left, n_right, n_items = [], [], [], [], []

    def add_node(idx_array):
        n_lo.append(lo[idx_array].min(axis=0))
        n_hi.append(hi[idx_array].max(axis=0))
        n_left.append(-1)
        n_right.append(-1)
        n_items.append(None)
        return len(n_lo) - 1

    root_items = np.arange(t, dtype=np.int64)
    root = add_node(root_items)
    stack = [(root, root_items)]

    while stack:
        node, items = stack.pop()
        if len(items) <= max_leaf:
            n_items[node] = items
            continue

        c = centroid[items]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        extent = cmax - cmin
        widest = int(np.argmax(extent))

        def sweep(lo_b, hi_b, n_b):
            cl = np.minimum.accumulate(lo_b, axis=0)
            ch = np.maximum.accumulate(hi_b, axis=0)
            cn = np.cumsum(n_b)
            ext = np.maximum(ch - cl, 0.0)
            area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                        + ext[:, 2] * ext[:, 0])
            return cn, area

        # binned SAH over all three axes (matches accel/cpp/bvh_builder);
        # best (axis, bin) pair wins
        left_items = right_items = None
        best_cost = np.inf
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = _N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)

            bin_lo = np.full((_N_BINS, 3), np.inf, F)
            bin_hi = np.full((_N_BINS, 3), -np.inf, F)
            bin_n = np.zeros(_N_BINS, np.int64)
            for b in np.unique(bins):
                sel = items[bins == b]
                bin_lo[b] = lo[sel].min(axis=0)
                bin_hi[b] = hi[sel].max(axis=0)
                bin_n[b] = len(sel)

            nl, al = sweep(bin_lo, bin_hi, bin_n)
            nr_rev, ar_rev = sweep(bin_lo[::-1], bin_hi[::-1], bin_n[::-1])
            nr = nr_rev[::-1]
            ar = ar_rev[::-1]
            cost = np.where(
                (nl[:-1] > 0) & (nr[1:] > 0),
                al[:-1] * nl[:-1] + ar[1:] * nr[1:],
                np.inf,
            )
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]) and cost[best] < best_cost:
                best_cost = cost[best]
                mask = bins <= best
                left_items, right_items = items[mask], items[~mask]

        if left_items is None:
            order = np.argsort(c[:, widest], kind="stable")
            half = len(items) // 2
            left_items, right_items = items[order[:half]], items[order[half:]]

        left = add_node(left_items)
        right = add_node(right_items)
        n_left[node] = left
        n_right[node] = right
        stack.append((right, right_items))
        stack.append((left, left_items))

    # ------------------------------------------------------------------
    # Flatten to DFS order with skip links
    # ------------------------------------------------------------------
    count = len(n_lo)
    bounds_lo = np.zeros((count, 3), F)
    bounds_hi = np.zeros((count, 3), F)
    skip = np.zeros(count, np.int32)
    tri_start = np.full(count, -1, np.int32)
    tri_count = np.zeros(count, np.int32)
    tri_order = np.zeros(t, np.int64)

    # subtree sizes (iterative post-order)
    size = np.ones(count, np.int64)
    post = []
    walk = [root]
    while walk:
        node = walk.pop()
        post.append(node)
        if n_items[node] is None:
            walk.append(n_left[node])
            walk.append(n_right[node])
    for node in reversed(post):
        if n_items[node] is None:
            size[node] = 1 + size[n_left[node]] + size[n_right[node]]

    out_idx = 0
    tri_cursor = 0
    walk = [root]
    while walk:
        node = walk.pop()
        me = out_idx
        out_idx += 1
        bounds_lo[me] = n_lo[node]
        bounds_hi[me] = n_hi[node]
        skip[me] = me + size[node]
        if n_items[node] is not None:
            items = n_items[node]
            tri_start[me] = tri_cursor
            tri_count[me] = len(items)
            tri_order[tri_cursor : tri_cursor + len(items)] = items
            tri_cursor += len(items)
        else:
            walk.append(n_right[node])
            walk.append(n_left[node])

    assert tri_cursor == t
    return BVH(bounds_lo, bounds_hi, skip, tri_start, tri_count, tri_order,
               max_leaf)


def validate_bvh(bvh: BVH, v0, v1, v2) -> None:
    """Structural invariants (used by tests)."""
    n = bvh.num_nodes
    assert (bvh.skip > np.arange(n)).all() and (bvh.skip <= n).all()
    leaves = bvh.tri_count > 0
    assert bvh.tri_count[leaves].max() <= bvh.max_leaf
    assert bvh.tri_count.sum() == len(bvh.tri_order)
    assert len(np.unique(bvh.tri_order)) == len(bvh.tri_order)
    # every leaf's triangles inside its bounds
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    for i in np.nonzero(leaves)[0][:64]:
        sel = bvh.tri_order[bvh.tri_start[i] : bvh.tri_start[i] + bvh.tri_count[i]]
        assert (lo[sel] >= bvh.bounds_lo[i] - 1e-4).all()
        assert (hi[sel] <= bvh.bounds_hi[i] + 1e-4).all()
