"""Binary-BVH traversal in torch, vectorised over rays (`tracer="bvh"`).

Port of platinum_tpu/ops/traverse.py: the stackless skip-link walk of the
DFS-ordered BVH from accel/bvh.py. Every live ray holds a node pointer;
one outer step first walks the inner nodes (up to 64 steps, each one
node-row gather and slab test against the ray's best t) until every live
ray is parked at a leaf whose box it hits, then tests each parked ray
against its leaf's (at most `max_leaf`) triangles with Möller-Trumbore
and moves it past the leaf (`skip`). A hit inner node sends the pointer to
ptr + 1, anything else to skip[ptr]. The arithmetic is the JAX module's:
`_slab_test` and `_mt_single` with its `t < tmax` accept and `inv_det`
product (not the packet kernel's scaled accept test), rays that are not
active start at `n_nodes`, the walk stops after 65,536 outer steps.

It is pure JAX in the reference (no Pallas kernel), so it is torch ops
here, a reference tracer on both packages: slow, and kept so.

Host syncs. The two JAX `while_loop`s test `any(live)` before each step;
in eager torch each such test is a host sync. The walk here tests it once
before every outer step and once every INNER_GROUP inner steps. The extra
steps this runs are no-ops, so the result is bitwise what testing before
every step gives: an inner step leaves `ptr` and `parked` as they were on
every ray that is not live (parked, past the end or, for any hit, done);
an outer step with no live ray parks nothing, tests nothing and moves no
pointer. The inner walk still stops at exactly 64 steps (INNER_GROUP
divides 64) and the outer count runs against `max_steps`. A sync drains
the launch queue, a step run past the walk's end costs its ~23 launches:
on the H100, four steps a test ran quicker than two or eight.

The leaf's slots are tested in one batch of Möller-Trumbore tests
against tmax = inf, then folded slot after slot: slot k is accepted where
it is valid and its t is below the best after slots < k, which is JAX's
test of slot k against tmax = that best (a t that passes one passes the
other; t = inf or NaN passes neither).

`oct_order` and the MT tiers (`mt_precision`) are options of the packet
kernel; JAX's make_tracers ignores them for this tracer without a word,
the port's refuses them (render/integrator.py).
"""

from __future__ import annotations

import torch

from platinum_tpu_torch.ops.frame import cross, dot
from platinum_tpu_torch.ops.intersect import DET_EPS, INF, HitRecord

INNER_CAP = 64          # inner steps per outer step (JAX traverse.py:116)
INNER_GROUP = 4         # inner steps between two tests of any(live)
MAX_STEPS = 65536       # outer steps (JAX traverse.py:82)


def _slab_test(o, inv_d, lo, hi, tmin, tmax):
    """Ray-AABB slab test; o, inv_d, lo, hi (R, 3)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tnear <= tfar) & (tfar >= tmin) & (tnear <= tmax)


def _mt_single(o, d, v0, e1, e2, tmin, tmax):
    """Möller-Trumbore for one triangle per ray; all (R, 3)."""
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


def _triangle_rows(geom):
    """(T + 1, 12) rows v0, e1, e2, pad of the BVH-ordered triangles,
    with one zero row past the end for the leaf slots beyond a leaf's
    count (masked anyway)."""
    if geom.tri_geo is not None:
        tg = geom.tri_geo
    else:
        idx = geom.indices.long()
        p = geom.positions
        v0 = p[idx[:, 0]]
        tg = torch.cat([v0, p[idx[:, 1]] - v0, p[idx[:, 2]] - v0,
                        torch.zeros_like(v0)], dim=-1)
    return torch.cat([tg, torch.zeros((1, tg.shape[1]), dtype=tg.dtype,
                                      device=tg.device)])


def _node_rows(flat):
    """(N, 12) node rows lo, hi, skip, tri_start, tri_count (int32 bits),
    pad: FlatScene.bvh_nodes, or packed from the separate arrays
    (JAX traverse.py:70-80)."""
    nodes = getattr(flat, "bvh_nodes", None)
    if nodes is not None:
        return nodes.contiguous()

    def as_f(x):
        return x.to(torch.int32).contiguous().view(torch.float32)[:, None]

    lo = flat.bvh_bounds_lo
    return torch.cat([lo, flat.bvh_bounds_hi, as_f(flat.bvh_skip),
                      as_f(flat.bvh_tri_start), as_f(flat.bvh_tri_count),
                      torch.zeros((lo.shape[0], 3), dtype=lo.dtype,
                                  device=lo.device)], dim=-1).contiguous()


def make_bvh_tracer(flat, max_leaf: int | None = None):
    """(trace_closest, trace_any) over the flat binary BVH. The triangles
    must already be in BVH leaf order (flatten does the reorder).

    trace_closest(o, d, tmin, tmax, active=None) -> HitRecord
    trace_any(o, d, tmin, tmax, active=None)     -> (R,) bool occlusion
    """
    tgp = _triangle_rows(flat.geometry)
    nodes = _node_rows(flat)
    n_nodes = nodes.shape[0]
    # one zero row past the end, read by the pointers that left the tree
    # (JAX clamps them to the last node): no ray that reads it is live,
    # so what it holds is masked, as there
    nodes = torch.cat([nodes, torch.zeros((1, nodes.shape[1]),
                                          dtype=nodes.dtype,
                                          device=nodes.device)])
    node_ints = nodes.view(torch.int32)
    n_tris = tgp.shape[0] - 1
    leaf_k = int(max_leaf) if max_leaf is not None else 4

    def _walk(o, d, tmin, tmax, any_hit: bool, active=None,
              max_steps=MAX_STEPS):
        r = o.shape[0]
        dev = o.device
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(r)
        best_t = torch.as_tensor(tmax, dtype=torch.float32,
                                 device=dev).expand(r).clone()
        inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20,
                                  torch.where(d < 0, -1e-20, 1e-20), d)
        # (lo, hi) - (o, o) times (inv_d, inv_d): both slabs in one op
        o2, inv2 = torch.cat([o, o], -1), torch.cat([inv_d, inv_d], -1)
        # rays that are not active never enter the tree
        ptr = (torch.zeros((r,), dtype=torch.int64, device=dev)
               if active is None else
               torch.where(active, 0, n_nodes).to(torch.int64))
        best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
        bu = torch.zeros((r,), device=dev)
        bv = torch.zeros((r,), device=dev)
        slots = torch.arange(leaf_k, device=dev)
        none = torch.zeros((r,), dtype=torch.bool, device=dev)

        steps = 0
        while steps < max_steps:
            # live: in the tree and, for any hit, not yet occluded
            live = ptr < n_nodes
            if any_hit:
                live = live & (best_tri < 0)
            if not bool(live.any()):
                break
            # phase 1: walk inner nodes until every live ray is parked at
            # a hit leaf (or done). A ray leaves `live` when it parks or
            # steps past the end, and nothing else changes within the walk
            done_early = (best_tri >= 0) if any_hit else none
            parked = done_early
            for inner in range(INNER_CAP):
                if (inner % INNER_GROUP == 0 and inner
                        and not bool(live.any())):
                    break
                row = nodes[ptr]
                rowi = row.view(torch.int32)
                t01 = (row[:, 0:6] - o2) * inv2
                t0, t1 = t01[:, 0:3], t01[:, 3:6]
                tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
                tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
                hit_box = ((tnear <= tfar) & (tfar >= tmin)
                           & (tnear <= best_t) & live)
                park = hit_box & (rowi[:, 8] > 0)
                # hit_box ^ park: a hit inner node; live ^ park: moves on
                step_to = torch.where(hit_box ^ park, ptr + 1,
                                      rowi[:, 6].long())
                moves = live ^ park
                ptr = torch.where(moves, step_to, ptr)
                parked = parked | park
                live = moves & (ptr < n_nodes)

            # phase 2: intersect the parked leaves, every slot in one
            # batch; the accept against the running best t (JAX tests slot
            # k with tmax = the best after slots < k) is the fold below
            rowi = node_ints[ptr]
            skip_to, base, count = rowi[:, 6], rowi[:, 7], rowi[:, 8]
            at_leaf = parked & (ptr < n_nodes) & ~done_early
            slot = at_leaf[:, None] & (slots < count[:, None])
            tri = torch.where(slot, base[:, None] + slots, n_tris)
            trow = tgp[tri]
            t, u_, v_, valid = _mt_single(
                o[:, None], d[:, None], trow[..., 0:3], trow[..., 3:6],
                trow[..., 6:9], tmin[:, None], INF)
            valid = valid & slot
            for k in range(leaf_k):
                ok = valid[:, k] & (t[:, k] < best_t)
                best_tri = torch.where(ok, tri[:, k].to(torch.int32),
                                       best_tri)
                bu = torch.where(ok, u_[:, k], bu)
                bv = torch.where(ok, v_[:, k], bv)
                best_t = torch.where(ok, t[:, k], best_t)
            ptr = torch.where(at_leaf, skip_to.long(), ptr)
            steps += 1

        hit = best_tri >= 0
        return HitRecord(t=torch.where(hit, best_t, INF), tri=best_tri,
                         bary=torch.stack([bu, bv], -1), hit=hit)

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        return _walk(o, d, tmin, tmax, any_hit=False, active=active)

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        return _walk(o, d, tmin, tmax, any_hit=True, active=active).hit

    return trace_closest, trace_any
