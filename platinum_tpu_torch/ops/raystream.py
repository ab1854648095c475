"""Breadth-first ray-stream traversal of the 16-wide BVH (accel.wide).

Port of platinum_tpu/ops/raystream.py. The whole wave advances one level
of the tree per phase, as dense torch ops plus one CUDA kernel:

  per level:
    1. (ray, node) pairs, sorted by node             [stable argsort]
    2. node records and child metas fetched per pair [gather]
    3. 16-child slab test, culled by per-ray best t  [dense ops]
    4. surviving inner children -> next level's pairs;
       surviving leaf children -> (ray, MT block) pairs, sorted by block
    5. the leaf-pair kernel (K15, csrc/stream_mt.cu, wrapper `stream_mt`):
       per pair the ray against the block's 64 triangles, each block
       staged once per CTA in shared memory for the pairs that share it
    6. per-ray closest-hit reduction and best-t update [scatter amin]

The contract is the JAX module's: closest hits are exact minima of t,
ties on exactly equal t go to the smallest global slot id; culling by the
per-ray best only ever admits extra work. Restrictions as there: one tree
level (no instancing), every leaf owns exactly one MT block.

Two things differ from the JAX module, both because of the machine.
The JAX module refuses every backend but the CPU, for a fault of the TPU
runtime in its scatter/argsort glue (raystream.py:261-274); that reason
is the TPU's, so this tracer runs on the card. And the JAX module sizes
every level's pair list statically (PAIR_CAPS, LEAF_CAP: XLA needs static
shapes), drops what does not fit and raises from the public entry; eager
torch sizes each list exactly (`nonzero`), at the price of one host sync
per level, so no pair is ever dropped: `.with_overflow` keeps its
signature and always reports 0. `.with_levels` returns every level's pair
and leaf-pair counts beside the result, for holding them against the JAX
module's caps.

`stream_mt` launches the kernel on CUDA tensors or raises; on CPU tensors
it runs `stream_mt_plain`, the same per-pair function as one batched
product over each pair's own block (`packet_trace.mt_product` at the tier),
which the tests and chip_smoke.py hold the kernel against. The pair names
its ray by index and the kernel forms the ray's features itself, with the
packet kernel's code (csrc/mt_block.cuh), so that a (ray, triangle)
pair's t is the packet tracer's to the bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from platinum_tpu_torch.ops.intersect import INF, HitRecord
from platinum_tpu_torch.ops.packet_trace import (DET_EPS, PRECISIONS, _check,
                                                 _no_tf32, load_library,
                                                 mt_product, ray_features)

TIERS = ("highest", "high", "default")
PLAIN_CHUNK = 1 << 15     # pairs per einsum of the plain version


def launch_key(any_hit: bool, mt_precision: str = "highest",
               per_pair: bool = False) -> str:
    """LAUNCHES key of one kernel mode: "closest" / "any", with a
    "+<tier>" suffix below "highest" and "+per_pair" for the
    one-thread-per-pair reference kernel."""
    key = "any" if any_hit else "closest"
    if mt_precision != "highest":
        key += f"+{mt_precision}"
    return key + "+per_pair" if per_pair else key


# Kernel launches per mode, counted where `stream_mt` launches and nowhere
# else
LAUNCHES = {launch_key(a, p, r): 0 for r in (False, True)
            for a in (False, True) for p in TIERS}


def _tree_depth(meta: np.ndarray) -> int:
    """Host-side BFS depth of the wide tree (root = level 0)."""
    meta16 = np.asarray(meta).reshape(-1, 16)
    depth, seen = 0, 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        seen += frontier.size
        if seen > meta16.size:  # malformed tree guard
            raise ValueError("cycle in wide-BVH meta table")
        kids = meta16[frontier].reshape(-1)
        frontier = kids[kids >= 0].astype(np.int64)
        if frontier.size:
            depth += 1
    return depth


def _all_leaves_single_block(meta: np.ndarray) -> bool:
    meta = np.asarray(meta)
    vals = -meta[meta <= -2] - 2
    return bool(np.all((vals & 31) == 1))


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("stream_mt_launch", "stream_mt_per_pair_launch"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p, i, p, p, p, i, p, i, i, i,
                                       p, p, p, p, p]
    lib.stream_mt_error_string.restype = ctypes.c_char_p
    lib.stream_mt_error_string.argtypes = [i]


def _check_tier(mt_precision: str):
    if mt_precision not in TIERS:
        raise ValueError(f"unknown mt_precision {mt_precision!r} for the "
                         f"ray-stream tracer; one of {TIERS}")


def stream_mt(rays, limit, pair_ray, pair_block, blocks, any_hit: bool,
              mt_precision: str = "highest", per_pair: bool = False):
    """Test P (ray, block) pairs, sorted by block id (K15).

    rays: (8, R) f32 rows [ox, oy, oz, dx, dy, dz, tmin, tmax] (tmax is
    not read); limit: (R,) f32, the t below which a hit counts (the ray's
    best so far; tmax for any hit); pair_ray, pair_block: (P,) i32, a
    block id of -1 marks padding; blocks: (B, 10, 256) f32. Returns (t,
    slot, u, v), each (P,): closest hit the pair's least t (+inf on a
    miss), slot = block*64 + slot of it (ties to the smallest slot; -1 on
    a miss) and its barycentrics; any hit slot = 1 where some triangle is
    accepted, else -1 (t = 0 / +inf). CPU tensors take the plain version;
    CUDA tensors the kernel: each CTA stages the blocks of a chunk of
    pairs in shared memory and tests several pairs a thread against each
    coefficient it reads, or with `per_pair` the one-thread-per-pair
    reference kernel (the same outputs in every bit)."""
    _check_tier(mt_precision)
    dev = rays.device
    if dev.type == "cpu":
        return stream_mt_plain(rays, limit, pair_ray, pair_block, blocks,
                               any_hit, mt_precision)
    if dev.type != "cuda":
        raise ValueError(f"stream_mt: unsupported device {dev}")
    r, n = rays.shape[1], pair_ray.shape[0]
    _check("rays", rays, torch.float32, (8, r), dev)
    _check("limit", limit, torch.float32, (r,), dev)
    _check("pair_ray", pair_ray, torch.int32, (n,), dev)
    _check("pair_block", pair_block, torch.int32, (n,), dev)
    _check("blocks", blocks, torch.float32, (blocks.shape[0], 10, 256), dev)
    if limit.shape[0] != r or pair_block.shape[0] != n:
        raise ValueError("limit must hold one value per ray and pair_block "
                         "one id per pair")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, slot, u, v
    lib = load_library("stream_mt", _declare)
    with torch.cuda.device(dev):
        entry = (lib.stream_mt_per_pair_launch if per_pair
                 else lib.stream_mt_launch)
        rc = entry(
            rays.data_ptr(), r, limit.data_ptr(), pair_ray.data_ptr(),
            pair_block.data_ptr(), n, blocks.data_ptr(), blocks.shape[0],
            int(bool(any_hit)), PRECISIONS[mt_precision], t.data_ptr(),
            slot.data_ptr(), u.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("stream_mt kernel launch failed: "
                           + lib.stream_mt_error_string(rc).decode())
    LAUNCHES[launch_key(any_hit, mt_precision, per_pair)] += 1
    return t, slot, u, v


def stream_mt_plain(rays, limit, pair_ray, pair_block, blocks, any_hit: bool,
                    mt_precision: str = "highest"):
    """Plain PyTorch version of `stream_mt`, with its outputs: per pair
    the product of its own block (`blocks[bid]`, as (256, 10)) with its
    ray's features at the tier (`mt_product`, batched over the pairs; no
    TF32), then the kernel's accept tests; closest hit the least t,
    ties to the smallest slot."""
    _check_tier(mt_precision)
    dev = rays.device
    _no_tf32(dev)
    n = pair_ray.shape[0]
    t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    feat = ray_features(rays)                              # (10, R)
    coef_all = blocks.transpose(1, 2)                      # (B, 256, 10)
    live = torch.nonzero(pair_block >= 0).squeeze(1)
    for c0 in range(0, live.numel(), PLAIN_CHUNK):
        idx = live[c0:c0 + PLAIN_CHUNK]
        pr, pb = pair_ray[idx].long(), pair_block[idx].long()
        # batched over pairs: (P, 256, 10) @ (P, 10, 1)
        out = mt_product(coef_all[pb], feat[:, pr].T[:, :, None],
                         mt_precision).view(-1, 4, 64)
        sign = torch.where(out[:, 0] >= 0.0, 1.0, -1.0)
        out = out * sign[:, None]
        ad, us, vs, ts = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
        lo, hi = rays[6, pr][:, None], limit[pr][:, None]
        ok = ((ad > DET_EPS) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
              & (ts > lo * ad) & (ts < hi * ad))
        if any_hit:
            occ = ok.any(dim=1)
            slot[idx] = torch.where(occ, 1, -1).to(torch.int32)
            t[idx] = torch.where(occ, 0.0, INF)
            continue
        t64 = torch.where(ok, ts / torch.clamp(ad, min=1e-37), INF)
        tb, arg = torch.min(t64, dim=1)    # first minimum: smallest slot
        found = torch.isfinite(tb)
        pick = arg[:, None]
        iad = 1.0 / torch.clamp(ad.gather(1, pick)[:, 0], min=1e-37)
        t[idx] = tb
        slot[idx] = torch.where(found, pb * 64 + arg, -1).to(torch.int32)
        u[idx] = torch.where(found, us.gather(1, pick)[:, 0] * iad, 0.0)
        v[idx] = torch.where(found, vs.gather(1, pick)[:, 0] * iad, 0.0)
    return t, slot, u, v


def make_stream_tracer(wnodes, wtris, wmeta, wslot=None,
                       mt_precision: str = "highest",
                       depth: int | None = None, mt_fn=stream_mt):
    """(trace_closest, trace_any) with the packet tracer's signature.

    wnodes: (N, 128) f32 node rows; wtris: (B, 10, 256) MT blocks; wmeta:
    (N*16,) i32 child metas; wslot: optional slot -> triangle id map;
    mt_precision: "highest", "high" or "default" (both modes run at it,
    raystream.py:156); depth: the tree's depth if the caller knows it.
    Runs on the tensors' device: the JAX module's refusal of accelerators
    rests on a fault of the TPU runtime and is not carried over. A tree
    with a multi-block leaf raises. `mt_fn` tests one level's leaf pairs
    with stream_mt's arguments: the kernel wrapper `stream_mt`, or
    `stream_mt_plain` to hold a render to the plain version."""
    _check_tier(mt_precision)
    meta_np = wmeta.detach().cpu().numpy()
    if depth is None:
        depth = _tree_depth(meta_np)
    if not _all_leaves_single_block(meta_np):
        raise ValueError("stream tracer v1 requires single-block leaves "
                         "(wide_leaf_cap <= 64, the build default)")
    n_nodes = wnodes.shape[0]
    nodes16 = wnodes.to(torch.float32).reshape(n_nodes, 16, 8).contiguous()
    meta16 = wmeta.to(torch.int32).reshape(n_nodes, 16).contiguous()
    blocks = wtris.to(torch.float32).contiguous()
    slot_map = wslot.long() if wslot is not None else None

    def _expand(pr, pn, o, iv, tmin, best):
        """One level: (C,) pair ray / node ids -> (C, 16) child hits and
        (C, 16) child metas."""
        rec = nodes16[pn]                                # (C, 16, 8)
        mts = meta16[pn]                                 # (C, 16)
        po, piv = o[pr][:, None, :], iv[pr][:, None, :]
        t0 = (rec[:, :, 0:3] - po) * piv
        t1 = (rec[:, :, 3:6] - po) * piv
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        mc = rec[:, :, 6]
        hit = ((tn <= tf) & (tf >= tmin[pr][:, None])
               & (tn <= best[pr][:, None]) & ((mc >= 0.0) | (mc <= -1.5)))
        return hit, mts

    def _run(o, d, tmin, tmax, active, any_hit):
        r = o.shape[0]
        dev = o.device
        o = o.to(torch.float32)
        d = d.to(torch.float32)
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(r)
        tmax = torch.as_tensor(tmax, dtype=torch.float32,
                               device=dev).expand(r)
        if active is not None:
            tmax = torch.where(active, tmax, tmin - 1.0)
        tiny = torch.where(d < 0, -1e-20, 1e-20)
        iv = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
        rays = torch.stack([o[:, 0], o[:, 1], o[:, 2],
                            d[:, 0], d[:, 1], d[:, 2], tmin, tmax])

        best = tmax.clone()
        win_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
        win_s = torch.full((r,), -1, dtype=torch.int32, device=dev)
        win_u = torch.zeros(r, dtype=torch.float32, device=dev)
        win_v = torch.zeros(r, dtype=torch.float32, device=dev)
        occluded = torch.zeros(r, dtype=torch.bool, device=dev)

        # level 0: every ray at the root, already sorted by node
        pr = torch.arange(r, device=dev)
        pn = torch.zeros(r, dtype=torch.long, device=dev)
        levels = []     # per level: (ray, node) pairs and leaf pairs

        for level in range(depth + 1):
            if any_hit:
                # occluded rays cull everything (best < tmin)
                best = torch.where(occluded, tmin - 1.0, best)
            hit, mts = _expand(pr, pn, o, iv, tmin, best)
            leaf_at = torch.nonzero(hit & (mts <= -2))
            inner_at = (torch.nonzero(hit & (mts >= 0))
                        if level < depth else None)
            levels.append(dict(level=level, pairs=int(pr.shape[0]),
                               leaf_pairs=int(leaf_at.shape[0])))

            # leaf pairs, sorted by block, through the kernel
            if leaf_at.shape[0]:
                lb = (-mts[leaf_at[:, 0], leaf_at[:, 1]] - 2) >> 5
                order = torch.argsort(lb, stable=True)
                lb_s = lb[order].contiguous()
                lr_s = pr[leaf_at[:, 0]][order]
                t_p, s_p, u_p, v_p = mt_fn(
                    rays, best.contiguous(),
                    lr_s.to(torch.int32).contiguous(), lb_s, blocks, any_hit,
                    mt_precision)
                if any_hit:
                    occluded[lr_s[s_p > 0]] = True
                else:
                    # per-ray reduction: exact min t, ties -> smallest slot
                    t_best = torch.full((r,), INF, dtype=torch.float32,
                                        device=dev).scatter_reduce_(
                        0, lr_s, t_p, reduce="amin")
                    cand = (t_p == t_best[lr_s]) & torch.isfinite(t_p)
                    big = torch.iinfo(torch.int32).max
                    s_best = torch.full((r,), big, dtype=torch.int32,
                                        device=dev).scatter_reduce_(
                        0, lr_s, torch.where(cand, s_p, big), reduce="amin")
                    winner = cand & (s_p == s_best[lr_s])
                    upd = t_best < win_t
                    win_t = torch.where(upd, t_best, win_t)
                    new = winner & upd[lr_s]     # one winner pair per ray
                    at = lr_s[new]
                    win_s[at] = s_p[new]
                    win_u[at] = u_p[new]
                    win_v[at] = v_p[new]
                    best = torch.minimum(best, win_t)

            # next level's pairs, sorted by node
            if level == depth or inner_at.shape[0] == 0:
                break
            npn = mts[inner_at[:, 0], inner_at[:, 1]].long()
            order = torch.argsort(npn, stable=True)
            pn = npn[order]
            pr = pr[inner_at[:, 0]][order]

        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if any_hit:
            return occluded, overflow, levels
        tri = win_s
        if slot_map is not None:
            tri = torch.where(tri >= 0,
                              slot_map[torch.clamp(tri, min=0).long()]
                              .to(torch.int32), -1)
        hit = tri >= 0
        rec = HitRecord(t=torch.where(hit, win_t, INF), tri=tri,
                        bary=torch.stack([win_u, win_v], dim=-1), hit=hit,
                        inst=None)
        return rec, overflow, levels

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        return _run(o, d, tmin, tmax, active, any_hit=False)[0]

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        return _run(o, d, tmin, tmax, active, any_hit=True)[0]

    def _attach(fn, any_hit):
        def with_overflow(o, d, tmin, tmax, active=None):
            """The JAX module's overflow-reporting entry: (result, pairs
            dropped). Every list is sized exactly here, so always 0."""
            return _run(o, d, tmin, tmax, active, any_hit)[:2]

        def with_levels(o, d, tmin, tmax, active=None):
            """(result, [{level, pairs, leaf_pairs}, ...])."""
            return _run(o, d, tmin, tmax, active, any_hit)[::2]

        fn.with_overflow, fn.with_levels = with_overflow, with_levels

    _attach(trace_closest, False)
    _attach(trace_any, True)
    return trace_closest, trace_any
