"""Breadth-first (level-synchronous) traversal of the 16-wide BVH, every
irregular step a hand-written CUDA kernel.

Port of platinum_tpu/ops/bfstream.py. `make_bf_tracer` keeps its name and
returns the same (trace_closest, trace_any) pair, with `.with_overflow`.
A wave is sorted by the packet tracer's octant + Morton key, cut into
segments of `seg_rays` rays, and each segment is traced level by level:

  per level L (one launch each, csrc/bf_stream.cu):
    K10 expand  per unit (one node x one 128-pair tile): slab-test the
                node's 16 children -> per-lane 16-bit masks, per-child
                counts
    K11 prefix  one block scans the level: distinct nodes, per-unit
                offsets into each child's region, 128-aligned regions in
                the next level's list (inner children) or the MT list
                (leaf children, cursor running across levels); then a
                grid fills the next level's unit table, the MT unit table
                and the regions' dead tail lanes (two launches, counted
                as "prefix" and "prefix fill")
    K12 emit    per unit: each surviving (ray, child) pair to its lane of
                the child's region
  then K13 mt   per MT unit (one leaf block x one tile): the 64-triangle
                block test, closest hit (t, slot id, u, v) or occlusion
  then K14 bwd  per level, deepest first: each pair keeps the least
                (t, slot id) of its children; level 0 holds the rays

The contract is the JAX module's (and the ray-stream tracer's): closest
hits exact in t against the packet kernel, ties on equal t to the smallest
slot id; occlusion exact. Restrictions as there: one tree level (an
instanced tree raises), every leaf owns exactly one MT block.

What differs from the JAX module, and why:
- A pair carries its ray's index into the wave's (8, R) ray table, -1 in
  a dead lane, instead of the ray's eight floats; K13 gathers the ray and
  forms its features with the packet kernel's code (csrc/mt_block.cuh),
  so a (ray, triangle) pair's t is K1's to the bit. The integer tables of
  every level are the JAX kernels' (tests/test_torch_bfstream.py holds
  them bitwise).
- Blocks run in no order, so K11 writes each unit's offset into each
  child's region and K12 / K14 need no running cursor; the level's unit
  count stays on the device, and a wave reads the status of its levels
  once, at its end.
- Overflow: the JAX module sizes every list statically (PAIR_CAP_MULT,
  MT_CAP_MULT, CAP_SLACK_TILES), counts the pairs that do not fit, and
  `trace_closest` / `trace_any` throw the count away (bfstream.py:1096-
  1102), so those pairs are lost without a word. Here the capacities start
  the same, and when the status read at the end of a wave reports lost
  pairs, the segment is traced again with every capacity raised to what
  the levels reported they need; that repeats until nothing is lost (a
  level's need is exact once every level above it fits, so at most depth
  + 2 times). No pair is ever dropped, and `.with_overflow` returns
  (result, 0).
- `seg_rays` bounded the pair lists by the TPU's VMEM (bfstream.py:83).
  The lists live in device memory here, so a segment holds a 512 x 512
  wave whole (SEG_RAYS): fewer launches per wave, and the result does not
  depend on the segment size (the per-ray minimum is over the same pairs).
- "two_phase" and unknown tiers raise ValueError at once (the JAX module
  fails late with a KeyError, bfstream.py:595-597).

Each kernel has a wrapper that launches it on CUDA tensors and raises on
failure, and beside it a plain PyTorch version of the same function
(vectorised over the level), which the wrapper runs for CPU tensors and
which the tests and chip_smoke.py hold the kernel against. Launches are
counted per kernel and mode in LAUNCHES, where the wrapper launches and
nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from platinum_tpu_torch.ops.intersect import DET_EPS, INF, HitRecord
from platinum_tpu_torch.ops.packet_trace import (DEAD_KEY, PRECISIONS,
                                                 SORT_MIN_NODES, _check,
                                                 _no_tf32, _ray_sort_key,
                                                 load_library, sort_frame)
from platinum_tpu_torch.ops.raystream import _tree_depth

LANES = 128
CHILDREN = 16
# static per-level pair-tile capacities as multiples of a segment's ray
# tiles, and the MT list's, as in the JAX module (bfstream.py:78-82); the
# port raises them where a wave needs more
PAIR_CAP_MULT = (1.0, 3.0, 3.0, 3.0, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5)
MT_CAP_MULT = 14.0
MT_WIN = 512              # the MT capacity is a multiple of it, as in JAX
CAP_SLACK_TILES = 768
SEG_RAYS = 512 * 512      # rays per segment: a headline wave in one
SORT_MIN_RAYS = 4 * LANES  # the JAX module sorts waves of >= 512 rays
MT_TAG = 1 << 30          # base-table tag: the child's region is in the MT list
TIERS = ("highest", "high", "default")
# words of a level's status row (csrc/bf_stream.cu)
NEXT, MT_CUR, LOST, NEED_NEXT, NEED_MT, LIVE_NEXT, LIVE_MT, DISTINCT = range(8)
STAT_WORDS = 8
PLAIN_TILES = 256         # MT tiles per product of the plain version


def launch_key(kernel: str, any_hit: bool = False,
               mt_precision: str = "highest") -> str:
    """LAUNCHES key: "expand", "prefix" (K11's scan), "prefix fill" (K11's
    fill), "emit", "bwd", or "mt closest" / "mt any" with a "+<tier>"
    suffix below "highest"."""
    key = kernel
    if kernel == "mt":
        key = "mt any" if any_hit else "mt closest"
        if mt_precision != "highest":
            key += f"+{mt_precision}"
    return key


# Kernel launches per kernel and mode, counted where a wrapper launches and
# nowhere else
LAUNCHES = {k: 0 for k in ("expand", "prefix", "prefix fill", "emit", "bwd")}
LAUNCHES.update({launch_key("mt", a, p): 0
                 for a in (False, True) for p in TIERS})


def _all_leaves_single_block(meta: np.ndarray, n_blocks: int) -> bool:
    """Every leaf owns exactly one MT block and names a plain block id; an
    instanced tree (accel.tlas) tags leaf values with inst << 19, so a
    decoded block id out of range is how it presents (bfstream.py:110-118)."""
    meta = np.asarray(meta)
    vals = -meta[meta <= -2].astype(np.int64) - 2
    return bool(np.all((vals & 31) == 1) and np.all((vals >> 5) < n_blocks))


def _check_tier(mt_precision: str):
    if mt_precision not in TIERS:
        raise ValueError(f"unknown mt_precision {mt_precision!r} for the "
                         f"breadth-first tracer; one of {TIERS} (two_phase "
                         f"is a mode of the packet kernel)")


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bf_expand_launch.argtypes = [p, p, i, p, p, i, p, i, p, p, p]
    lib.bf_prefix_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p,
                                     p, p, p, p, p, p]
    lib.bf_emit_launch.argtypes = [p, p, p, i, p, p, p, p, p, p]
    lib.bf_mt_launch.argtypes = [p, p, p, i, p, i, p, i, i, i, p, p, p, p, p]
    lib.bf_bwd_launch.argtypes = [p, p, i, p, p, p, p, p, p, p, p, p, p, p,
                                  p, p, p, p, p]
    for name in ("expand", "prefix", "emit", "mt", "bwd"):
        getattr(lib, f"bf_{name}_launch").restype = i
    lib.bf_resident_grids.argtypes = [p]
    lib.bf_resident_grids.restype = i
    lib.bf_error_string.restype = ctypes.c_char_p
    lib.bf_error_string.argtypes = [i]


def _launch(kernel: str, dev, *args):
    """Launch bf_<kernel>_launch(*args, stream) on dev's current stream,
    tensors passed as their data pointers; raise if it fails."""
    lib = load_library("bf_stream", _declare)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = getattr(lib, f"bf_{kernel}_launch")(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bf_stream {kernel} kernel launch failed: "
                           + lib.bf_error_string(rc).decode())


def resident_grids(dev) -> dict:
    """The CTAs the persistent kernels launch on `dev` (a CUDA device): the
    card's SMs times the CTAs an SM holds of K13 (closest and any hit, at
    "highest"), K14 and K12 (which launches at most a CTA per four units
    of the capacity)."""
    lib = load_library("bf_stream", _declare)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        rc = lib.bf_resident_grids(out)
    if rc != 0:
        raise RuntimeError("bf_stream occupancy query failed: "
                           + lib.bf_error_string(rc).decode())
    return {"mt closest": out[0], "mt any": out[1], "bwd": out[2],
            "emit": out[3]}


def _device(x, name):
    """'cpu' or 'cuda' for the wrapper's tensors; raises for others."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bf_{name}: unsupported device {x.device}")
    return x.device.type


def _count(level) -> int:
    """The unit count of a level (its status row's NEXT word) on the host."""
    return int(level[NEXT])


def _inv_dir(d):
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    return 1.0 / torch.where(d.abs() < 1e-20, tiny, d)


# ---------------------------------------------------------------------------
# K10 expand
# ---------------------------------------------------------------------------

def bf_expand(units, level, pairs, rays, nodes):
    """Slab-test every lane of the level's units against its node's 16
    children (K10). units (cap,) i32 node ids; level (8,) i32 the status
    row whose NEXT word is the unit count; pairs (cap, 128) i32 ray
    indices (-1 dead); rays (8, R) f32; nodes (N, 16, 8) f32. Returns
    masks (cap, 128) i32 (bit c: child c's box is hit within [tmin, tmax]
    and the slot is not empty) and counts (cap, 16) i32, for the units
    below the count (the rest are not written). CUDA tensors take the
    kernel (a block per unit, each lane's ray loaded with the node row,
    only the node's non-empty children tested)."""
    if _device(rays, "expand") == "cpu":
        return bf_expand_plain(units, level, pairs, rays, nodes)
    out = expand_kernel(units, level, pairs, rays, nodes)
    LAUNCHES["expand"] += 1
    return out


def expand_kernel(units, level, pairs, rays, nodes):
    """`bf_expand` through the kernel, uncounted: check, allocate,
    launch."""
    dev = rays.device
    cap = units.shape[0]
    _check("units", units, torch.int32, (cap,), dev)
    _check("level", level, torch.int32, (STAT_WORDS,), dev)
    _check("pairs", pairs, torch.int32, (cap, LANES), dev)
    _check("rays", rays, torch.float32, (8, rays.shape[1]), dev)
    _check("nodes", nodes, torch.float32, (nodes.shape[0], 16, 8), dev)
    masks = torch.empty((cap, LANES), dtype=torch.int32, device=dev)
    counts = torch.empty((cap, CHILDREN), dtype=torch.int32, device=dev)
    _launch("expand", dev, units, level,
            cap, pairs, rays, rays.shape[1], nodes, nodes.shape[0], masks,
            counts)
    return masks, counts


def bf_expand_plain(units, level, pairs, rays, nodes):
    """Plain PyTorch version of `bf_expand` (bfstream.py:143-211): the
    same slab test with the same operations, on all units at once; rows
    past the unit count are zero."""
    dev = rays.device
    cap, n, nr = units.shape[0], _count(level), rays.shape[1]
    masks = torch.zeros((cap, LANES), dtype=torch.int32, device=dev)
    counts = torch.zeros((cap, CHILDREN), dtype=torch.int32, device=dev)
    if n == 0:
        return masks, counts
    rec = nodes[units[:n].long().clamp(0, nodes.shape[0] - 1)]  # (n, 16, 8)
    r = pairs[:n].long()
    live = (r >= 0) & (r < nr)
    g = rays[:, r.clamp(0, nr - 1)]                          # (8, n, 128)
    o = g[0:3, :, None, :]
    iv = _inv_dir(g[3:6])[:, :, None, :]
    lo = rec[:, :, 0:3].permute(2, 0, 1)[..., None]          # (3, n, 16, 1)
    hi = rec[:, :, 3:6].permute(2, 0, 1)[..., None]
    t0, t1 = (lo - o) * iv, (hi - o) * iv
    tn = torch.minimum(t0, t1).amax(dim=0)                   # (n, 16, 128)
    tf = torch.maximum(t0, t1).amin(dim=0)
    tmin, tmax = g[6][:, None, :], g[7][:, None, :]
    meta = rec[:, :, 6:7]
    hit = ((tn <= tf) & (tf >= tmin) & (tn <= tmax) & (tmax >= tmin)
           & ((meta >= 0.0) | (meta <= -1.5)) & live[:, None, :])
    bit = torch.arange(CHILDREN, device=dev, dtype=torch.int32)[None, :, None]
    masks[:n] = (hit.to(torch.int32) << bit).sum(dim=1, dtype=torch.int32)
    counts[:n] = hit.sum(dim=2, dtype=torch.int32)
    return masks, counts


# ---------------------------------------------------------------------------
# K11 prefix
# ---------------------------------------------------------------------------

def bf_prefix(units, level, counts, meta, cap_next, mt_cap, pairs_next,
              mt_pairs, mt_units, stat_out):
    """Allocate the level's child regions (K11). units, counts as
    `bf_expand` had them; level (8,) the status row before (its NEXT word
    the unit count, its MT_CUR word the MT cursor); meta (N*16,) i32;
    cap_next, mt_cap: the tiles of the next level's list and of the MT
    list. Writes, in place, the dead tail lanes of every region into
    pairs_next (cap_next * 128,) or mt_pairs (mt_cap * 128,) and the
    regions' entries of mt_units (mt_cap,), and this level's status row
    stat_out (8,): next unit count, MT cursor, pairs lost, tiles needed
    next and in the MT list, live pairs next and in the MT list, distinct
    nodes. Returns dn (cap,) distinct-node index per unit, base (cap*16,)
    per (distinct node, child): first tile of its region, | MT_TAG in the
    MT list, -1 without one; uoff (cap, 16) each unit's offset into each
    child's region; units_next (cap_next,) node per next-level tile.
    Children are taken in (node, child) order while their regions fit."""
    if _device(counts, "prefix") == "cpu":
        return bf_prefix_plain(units, level, counts, meta, cap_next, mt_cap,
                               pairs_next, mt_pairs, mt_units, stat_out)
    out = prefix_kernel(units, level, counts, meta, cap_next, mt_cap,
                        pairs_next, mt_pairs, mt_units, stat_out)
    LAUNCHES["prefix"] += 1         # the scan
    LAUNCHES["prefix fill"] += 1    # the fill
    return out


def prefix_kernel(units, level, counts, meta, cap_next, mt_cap, pairs_next,
                  mt_pairs, mt_units, stat_out):
    """`bf_prefix` through the kernel, uncounted."""
    dev = counts.device
    cap = units.shape[0]
    _check("units", units, torch.int32, (cap,), dev)
    _check("level", level, torch.int32, (STAT_WORDS,), dev)
    _check("counts", counts, torch.int32, (cap, CHILDREN), dev)
    _check("meta", meta, torch.int32, (meta.shape[0],), dev)
    _check("stat_out", stat_out, torch.int32, (STAT_WORDS,), dev)
    for name, x, size in (("pairs_next", pairs_next, cap_next * LANES),
                          ("mt_pairs", mt_pairs, mt_cap * LANES),
                          ("mt_units", mt_units, mt_cap)):
        _check(name, x, torch.int32, (x.shape[0],), dev)
        if x.shape[0] < size:
            raise ValueError(f"{name} holds {x.shape[0]} entries, the "
                             f"capacity needs {size}")
    dn = torch.empty(cap, dtype=torch.int32, device=dev)
    base = torch.empty(cap * CHILDREN, dtype=torch.int32, device=dev)
    uoff = torch.empty((cap, CHILDREN), dtype=torch.int32, device=dev)
    node_id = torch.empty(cap, dtype=torch.int32, device=dev)
    node_base = torch.empty((cap + 1) * CHILDREN, dtype=torch.int32,
                            device=dev)
    units_next = torch.empty(max(cap_next, 1), dtype=torch.int32, device=dev)
    _launch("prefix", dev, units, level, counts, meta,
            meta.shape[0] // CHILDREN, cap, cap_next, mt_cap, dn, base, uoff,
            node_id, node_base, units_next, pairs_next, mt_units, mt_pairs,
            stat_out)
    return dn, base, uoff, units_next


def _exclusive_cumsum(x, dim=0):
    return torch.cumsum(x, dim=dim) - x


def bf_prefix_plain(units, level, counts, meta, cap_next, mt_cap, pairs_next,
                    mt_pairs, mt_units, stat_out):
    """Plain PyTorch version of `bf_prefix` (bfstream.py:249-381 under
    prefix allocation): the same tables from cumulative sums over the
    level, the same in-place writes; entries past the level's units,
    distinct nodes and regions are zero (-1 in base)."""
    dev = counts.device
    cap, n, mt0 = units.shape[0], _count(level), int(level[MT_CUR])
    n_nodes = meta.shape[0] // CHILDREN
    dn = torch.zeros(cap, dtype=torch.int32, device=dev)
    base = torch.full((cap * CHILDREN,), -1, dtype=torch.int32, device=dev)
    uoff = torch.zeros((cap, CHILDREN), dtype=torch.int32, device=dev)
    units_next = torch.zeros(max(cap_next, 1), dtype=torch.int32, device=dev)
    u = units[:n].long()
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = u[1:] != u[:-1]
    d = torch.cumsum(is_new.long(), 0) - 1
    first = torch.nonzero(is_new).squeeze(1)
    nd = first.numel()
    cnt = counts[:n].long()
    prefix = _exclusive_cumsum(cnt)                      # over all units
    node_base = torch.cat([prefix[first], cnt.sum(0, keepdim=True)])
    dn[:n] = d.to(torch.int32)
    uoff[:n] = (prefix - node_base[d]).to(torch.int32)
    acc = (node_base[1:] - node_base[:-1]).reshape(-1)   # (nd * 16,)
    node = u[first].clamp(0, n_nodes - 1)
    meta_c = meta.view(n_nodes, CHILDREN)[node].reshape(-1).long()
    tiles = (acc + LANES - 1) // LANES
    active = acc > 0
    inner = active & (meta_c >= 0)
    leaf = active & (meta_c < 0)
    at_next = _exclusive_cumsum(torch.where(inner, tiles, 0))
    at_mt = mt0 + _exclusive_cumsum(torch.where(leaf, tiles, 0))
    take_next = inner & (at_next + tiles <= cap_next)
    take_mt = leaf & (at_mt + tiles <= mt_cap)
    base[:nd * CHILDREN] = torch.where(
        take_next, at_next, torch.where(take_mt, MT_TAG | at_mt, -1)).to(
            torch.int32)
    took_next = int(tiles[take_next].sum())
    took_mt = int(tiles[take_mt].sum())
    units_next[:took_next] = torch.repeat_interleave(
        meta_c[take_next], tiles[take_next]).to(torch.int32)
    mt_units[mt0:mt0 + took_mt] = torch.repeat_interleave(
        (-meta_c[take_mt] - 2) >> 5, tiles[take_mt]).to(torch.int32)
    rem = acc - (tiles - 1) * LANES
    lane = torch.arange(LANES, device=dev)
    for take, at, lanes in ((take_next, at_next, pairs_next),
                            (take_mt, at_mt, mt_pairs)):
        tail = take & (rem < LANES)
        rows = (at + tiles - 1)[tail]
        dead = lane[None, :] >= rem[tail][:, None]
        view = lanes.view(-1, LANES)
        view[rows] = torch.where(dead, -1, view[rows])
    lost = int(acc[(inner & ~take_next) | (leaf & ~take_mt)].sum())
    stat_out.copy_(torch.tensor(
        [took_next, mt0 + took_mt, lost,
         int(torch.where(inner, tiles, 0).sum()),
         mt0 + int(torch.where(leaf, tiles, 0).sum()),
         int(acc[take_next].sum()), int(acc[take_mt].sum()), nd],
        dtype=torch.int32))
    return dn, base, uoff, units_next


# ---------------------------------------------------------------------------
# K12 emit, K14 bwd: the routing of a lane to its child's region
# ---------------------------------------------------------------------------

def _routes(masks, n, dn, uoff, base):
    """For the first n units: (bits (n, 16, 128) bool: the lane has child
    c, with a region; pos (n, 16, 128) long: its lane in the list; in_mt
    (n, 16, 1) bool: the region is in the MT list)."""
    dev = masks.device
    shift = torch.arange(CHILDREN, device=dev, dtype=torch.int32)[None, :,
                                                                   None]
    bits = ((masks[:n][:, None, :] >> shift) & 1).long()
    rank = _exclusive_cumsum(bits, dim=2)
    rec = base.view(-1, CHILDREN)[dn[:n].long()].long()[:, :, None]
    pos = ((rec & (MT_TAG - 1)) * LANES + uoff[:n].long()[:, :, None]
           + rank)
    return (bits > 0) & (rec >= 0), pos, rec >= MT_TAG


def bf_emit(pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs):
    """Write each surviving (ray, child) pair's ray index into its child's
    region (K12), in place into pairs_next / mt_pairs: lane base + uoff +
    rank, rank = the lanes below it in the tile with the same child bit.
    CUDA tensors take the kernel (the CTAs the card holds, a warp per
    unit, ranks from the warp's four ballots of each child some lane
    has)."""
    if _device(pairs, "emit") == "cpu":
        return bf_emit_plain(pairs, masks, level, dn, uoff, base, pairs_next,
                             mt_pairs)
    emit_kernel(pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs)
    LAUNCHES["emit"] += 1


def emit_kernel(pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs):
    """`bf_emit` through the kernel, uncounted."""
    dev = pairs.device
    cap = pairs.shape[0]
    _check("pairs", pairs, torch.int32, (cap, LANES), dev)
    _check("masks", masks, torch.int32, (cap, LANES), dev)
    _check("level", level, torch.int32, (STAT_WORDS,), dev)
    _check("dn", dn, torch.int32, (cap,), dev)
    _check("uoff", uoff, torch.int32, (cap, CHILDREN), dev)
    _check("base", base, torch.int32, (cap * CHILDREN,), dev)
    for name, x in (("pairs_next", pairs_next), ("mt_pairs", mt_pairs)):
        _check(name, x, torch.int32, (x.shape[0],), dev)
    _launch("emit", dev, pairs, masks, level, cap, dn, uoff, base,
            pairs_next, mt_pairs)


def bf_emit_plain(pairs, masks, level, dn, uoff, base, pairs_next, mt_pairs):
    """Plain PyTorch version of `bf_emit` (bfstream.py:436-544): ranks by
    a cumulative sum over the lanes, one scatter per list."""
    n = _count(level)
    if n == 0:
        return
    sel, pos, in_mt = _routes(masks, n, dn, uoff, base)
    src = pairs[:n][:, None, :].expand(-1, CHILDREN, -1)
    for dest, keep in ((pairs_next, sel & ~in_mt), (mt_pairs, sel & in_mt)):
        dest[pos[keep]] = src[keep]


# ---------------------------------------------------------------------------
# K13 mt
# ---------------------------------------------------------------------------

def bf_mt(mt_pairs, mt_units, level, rays, blocks, any_hit: bool,
          mt_precision: str = "highest"):
    """Test each MT unit's lanes against its block's 64 triangles (K13).
    mt_pairs (mt_cap * 128,) i32 ray indices; mt_units (mt_cap,) block
    ids; level (8,) the last level's status row, whose MT_CUR word is the
    units' count; rays (8, R); blocks (B, 10, 256) f32. Returns (t, sid,
    u, v), each (mt_cap * 128,): closest hit the least t in (tmin, tmax)
    (+inf on a miss), sid = block*64 + slot (ties to the smallest slot; -1
    on a miss) and its barycentrics; any hit t = 0, sid = 0 when some
    triangle is accepted. The tier's products are mt_block.cuh's. Units
    past the count are not written. CUDA tensors take the kernel (the
    CTAs the card holds take the tiles in turn, a tile's live lanes two
    rays a thread)."""
    if _device(rays, "mt") == "cpu":
        return bf_mt_plain(mt_pairs, mt_units, level, rays, blocks, any_hit,
                           mt_precision)
    out = mt_kernel(mt_pairs, mt_units, level, rays, blocks, any_hit,
                    mt_precision)
    LAUNCHES[launch_key("mt", any_hit, mt_precision)] += 1
    return out


def mt_kernel(mt_pairs, mt_units, level, rays, blocks, any_hit: bool,
              mt_precision: str = "highest"):
    """`bf_mt` through the kernel, uncounted."""
    _check_tier(mt_precision)
    dev = rays.device
    cap = mt_units.shape[0]
    _check("mt_pairs", mt_pairs, torch.int32, (cap * LANES,), dev)
    _check("mt_units", mt_units, torch.int32, (cap,), dev)
    _check("level", level, torch.int32, (STAT_WORDS,), dev)
    _check("rays", rays, torch.float32, (8, rays.shape[1]), dev)
    _check("blocks", blocks, torch.float32, (blocks.shape[0], 10, 256), dev)
    if mt_pairs.shape[0] != cap * LANES:
        raise ValueError("mt_pairs must hold 128 lanes per MT unit")
    t = torch.empty(cap * LANES, dtype=torch.float32, device=dev)
    sid = torch.empty(cap * LANES, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    _launch("mt", dev, mt_pairs, mt_units, level, cap, rays, rays.shape[1],
            blocks, blocks.shape[0], int(bool(any_hit)),
            PRECISIONS[mt_precision], t, sid, u, v)
    return t, sid, u, v


def _fma(a, b, c):
    """fp32 a * b + c rounded once, as a CUDA fmaf: the product is exact
    in float64 and the sum is rounded there first (a second rounding that
    can differ from fmaf's only at an fp32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _features(g):
    """(10, ...) MT features [d, o x d, o, 1] of gathered rays g (8, ...)
    as mt_block.cuh's `ray_features` forms them: each cross term one
    rounded product and one FMA."""
    ox, oy, oz, dx, dy, dz = g[0], g[1], g[2], g[3], g[4], g[5]
    return torch.stack([dx, dy, dz,
                        _fma(oy, dz, -(oz * dy)),
                        _fma(oz, dx, -(ox * dz)),
                        _fma(ox, dy, -(oy * dx)),
                        ox, oy, oz, torch.ones_like(ox)])


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _block_outputs(coef, feat, mt_precision):
    """(T, 256, 128) outputs of tiles' blocks coef (T, 10, 256) with their
    lanes' features feat (10, T, 128), summed over the ten rows in order
    as mt_block.cuh does: "highest" one FMA per row; "high" the products
    ch*fh, ch*fl, cl*fh (exact in fp32) in three sums added in that order;
    "default" ch*fh alone."""
    c = coef[:, :, :, None]                           # (T, 10, 256, 1)
    f = feat.permute(1, 0, 2)[:, :, None, :]          # (T, 10, 1, 128)
    if mt_precision == "highest":
        acc = torch.zeros(c.shape[0], 256, f.shape[-1], device=coef.device)
        for k in range(10):
            acc = _fma(c[:, k], f[:, k], acc)
        return acc
    ch, fh = _bf16(c), _bf16(f)
    hh = torch.zeros(c.shape[0], 256, f.shape[-1], device=coef.device)
    hl, lh = torch.zeros_like(hh), torch.zeros_like(hh)
    cl, fl = _bf16(c - ch), _bf16(f - fh)
    for k in range(10):
        hh = hh + ch[:, k] * fh[:, k]
        if mt_precision == "high":
            hl = hl + ch[:, k] * fl[:, k]
            lh = lh + cl[:, k] * fh[:, k]
    return hh if mt_precision == "default" else (hh + hl) + lh


def bf_mt_plain(mt_pairs, mt_units, level, rays, blocks, any_hit: bool,
                mt_precision: str = "highest"):
    """Plain PyTorch version of `bf_mt` (bfstream.py:585-702), with its
    outputs: per tile the product of its block with its lanes' features,
    summed row by row in the kernel's order (no TF32), then the kernel's
    accept tests; closest hit the least t, ties to the smallest slot,
    found only below tmax as in mt_block.cuh's block test. Units past the
    count miss."""
    _check_tier(mt_precision)
    dev = rays.device
    _no_tf32(dev)
    cap, nr = mt_units.shape[0], rays.shape[1]
    n = int(level[MT_CUR])
    t = torch.full((cap * LANES,), INF, dtype=torch.float32, device=dev)
    sid = torch.full((cap * LANES,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(cap * LANES, dtype=torch.float32, device=dev)
    v = torch.zeros(cap * LANES, dtype=torch.float32, device=dev)
    for t0 in range(0, n, PLAIN_TILES):
        t1 = min(n, t0 + PLAIN_TILES)
        r = mt_pairs[t0 * LANES:t1 * LANES].view(-1, LANES).long()
        live = (r >= 0) & (r < nr)
        g = rays[:, r.clamp(0, nr - 1)]                    # (8, T, 128)
        blk = mt_units[t0:t1].long().clamp(0, blocks.shape[0] - 1)
        out = _block_outputs(blocks[blk], _features(g), mt_precision)
        out = out.view(-1, 4, 64, LANES)
        sign = torch.where(out[:, 0] >= 0.0, 1.0, -1.0)
        ad, us, vs, ts = (out[:, q] * sign for q in range(4))
        lo, hi = g[6][:, None, :], g[7][:, None, :]
        ok = ((ad > DET_EPS) & (us >= 0.0) & (vs >= 0.0) & (us + vs <= ad)
              & (ts > lo * ad) & (ts < hi * ad) & live[:, None, :])
        sl = slice(t0 * LANES, t1 * LANES)
        if any_hit:
            occ = ok.any(dim=1).reshape(-1)
            t[sl] = torch.where(occ, 0.0, INF)
            sid[sl] = torch.where(occ, 0, -1).to(torch.int32)
            continue
        tt = torch.where(ok, ts / torch.clamp(ad, min=1e-37), INF)
        tb, arg = torch.min(tt, dim=1)        # first minimum: smallest slot
        found = tb < g[7]
        pick = arg[:, None, :]
        iad = 1.0 / torch.clamp(ad.gather(1, pick)[:, 0], min=1e-37)
        t[sl] = torch.where(found, tb, INF).reshape(-1)
        sid[sl] = torch.where(found, blk[:, None] * 64 + arg,
                              -1).to(torch.int32).reshape(-1)
        u[sl] = torch.where(found, us.gather(1, pick)[:, 0] * iad,
                            0.0).reshape(-1)
        v[sl] = torch.where(found, vs.gather(1, pick)[:, 0] * iad,
                            0.0).reshape(-1)
    return t, sid, u, v


# ---------------------------------------------------------------------------
# K14 bwd
# ---------------------------------------------------------------------------

def bf_bwd(masks, level, dn, uoff, base, child, mt):
    """Each lane of the level's units keeps the least (t, sid) of its
    children's results (K14): inner children from `child` (the level
    below's (t, sid, u, v), or None where the level has no inner child),
    leaf children from `mt` (K13's). Returns (t, sid, u, v), each
    (cap * 128,): +inf / -1 / 0 / 0 for a lane without a result; units
    past the count are not written. CUDA tensors take the kernel (CTAs
    the card holds striding over the units, a lane's loads issued
    together)."""
    if _device(masks, "bwd") == "cpu":
        return bf_bwd_plain(masks, level, dn, uoff, base, child, mt)
    out = bwd_kernel(masks, level, dn, uoff, base, child, mt)
    LAUNCHES["bwd"] += 1
    return out


def bwd_kernel(masks, level, dn, uoff, base, child, mt):
    """`bf_bwd` through the kernel, uncounted."""
    dev = masks.device
    cap = masks.shape[0]
    _check("masks", masks, torch.int32, (cap, LANES), dev)
    _check("level", level, torch.int32, (STAT_WORDS,), dev)
    _check("dn", dn, torch.int32, (cap,), dev)
    _check("uoff", uoff, torch.int32, (cap, CHILDREN), dev)
    _check("base", base, torch.int32, (cap * CHILDREN,), dev)
    child = mt if child is None else child    # never read: no inner child
    for name, res in (("child", child), ("mt", mt)):
        for i, x in enumerate(res):
            _check(f"{name}[{i}]", x,
                   torch.int32 if i == 1 else torch.float32,
                   (res[0].shape[0],), dev)
    t = torch.empty(cap * LANES, dtype=torch.float32, device=dev)
    sid = torch.empty(cap * LANES, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    _launch("bwd", dev, masks, level, cap, dn, uoff, base, *child, *mt, t,
            sid, u, v)
    return t, sid, u, v


def bf_bwd_plain(masks, level, dn, uoff, base, child, mt):
    """Plain PyTorch version of `bf_bwd` (bfstream.py:733-846): the
    children's results gathered by the routes, then the least t, among
    equal t the least sid, over the 16 children at once."""
    dev = masks.device
    cap, n = masks.shape[0], _count(level)
    t = torch.full((cap * LANES,), INF, dtype=torch.float32, device=dev)
    sid = torch.full((cap * LANES,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(cap * LANES, dtype=torch.float32, device=dev)
    v = torch.zeros(cap * LANES, dtype=torch.float32, device=dev)
    if n == 0:
        return t, sid, u, v
    sel, pos, in_mt = _routes(masks, n, dn, uoff, base)
    got = []
    for i in range(4):
        from_mt = mt[i][torch.where(sel & in_mt, pos, 0)]
        if child is None:
            got.append(from_mt)
        else:
            from_child = child[i][torch.where(sel & ~in_mt, pos, 0)]
            got.append(torch.where(in_mt, from_mt, from_child))
    tc = torch.where(sel, got[0], INF)
    sc = torch.where(sel, got[1], -1)
    best = tc.amin(dim=1, keepdim=True)
    tied = sel & (tc == best)
    big = torch.iinfo(torch.int32).max
    smin = torch.where(tied, sc, big).amin(dim=1, keepdim=True)
    pick = (tied & (sc == smin)).to(torch.int8).argmax(dim=1, keepdim=True)
    have = tied.any(dim=1)
    sl = slice(0, n * LANES)
    t[sl] = torch.where(have, best[:, 0], INF).reshape(-1)
    sid[sl] = torch.where(have, sc.gather(1, pick)[:, 0], -1).reshape(-1)
    u[sl] = torch.where(have, got[2].gather(1, pick)[:, 0], 0.0).reshape(-1)
    v[sl] = torch.where(have, got[3].gather(1, pick)[:, 0], 0.0).reshape(-1)
    return t, sid, u, v


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

def _cdiv(a, b):
    return -(-a // b)


def segment_caps(rt: int, depth: int):
    """The JAX module's static capacities of a segment of rt ray tiles
    (bfstream.py:934-947): tiles of each level's pair list (level 0 = rt)
    and of the MT list."""
    caps = [rt]
    for lvl in range(1, depth + 2):
        mult = PAIR_CAP_MULT[min(lvl, len(PAIR_CAP_MULT) - 1)]
        caps.append(int(np.ceil(mult * rt)) + CAP_SLACK_TILES)
    mt_cap = _cdiv(int(np.ceil(MT_CAP_MULT * rt)) + 512, MT_WIN) * MT_WIN
    return caps, mt_cap


# the five steps of a segment, by name: the wrappers (kernels on CUDA
# tensors, plain versions on CPU tensors)
WRAPPERS = dict(expand=bf_expand, prefix=bf_prefix, emit=bf_emit, mt=bf_mt,
                bwd=bf_bwd)


def make_bf_tracer(wnodes, wtris, wmeta, wslot=None, sort: bool | None = None,
                   mt_precision: str = "highest", seg_rays: int = SEG_RAYS,
                   depth: int | None = None, steps=None):
    """(trace_closest, trace_any) with the packet tracer's signature.

    wnodes: (N, 128) f32 node rows; wtris: (B, 10, 256) f32 MT blocks;
    wmeta: (N*16,) i32 child metas; wslot: optional slot -> triangle id
    map. `sort` orders a wave by octant + Morton key (default: trees of
    more than 64 nodes, waves of at least 512 rays, as in the JAX module);
    `mt_precision`: "highest", "high" or "default" for both modes (K13's
    tier; "two_phase" and others raise ValueError); `seg_rays`: rays per
    segment (the results do not depend on it); `depth`: the tree's depth
    when the caller knows it (RenderSettings.bf_depth), else computed
    here. An instanced tree or a leaf of more than one block raises
    ValueError. Runs on the tensors' device: CUDA tensors go through the
    kernels, CPU tensors through their plain versions. `steps` replaces
    the five steps (WRAPPERS) by others with their signatures (the CUDA
    sources' host emulation, tools/torch_emulate_kernels.py).

    `trace_closest.with_overflow(o, d, tmin, tmax, active)` returns
    (HitRecord, 0) and `trace_any.with_overflow` (occluded, 0): a segment
    that overflows its capacities is traced again with larger ones, so no
    pair is lost. `.with_levels(...)` returns (result, segments): per
    segment its capacities, how many times it was traced, every level's
    status row and the tensors the kernels read and wrote on its last
    trace (for chip_smoke.py)."""
    _check_tier(mt_precision)
    steps = steps or WRAPPERS
    meta_np = wmeta.detach().cpu().numpy()
    n_blocks = wtris.shape[0]
    if depth is None:
        depth = _tree_depth(meta_np)
    if not _all_leaves_single_block(meta_np, n_blocks):
        raise ValueError("the breadth-first tracer requires single-block "
                         "leaves and a plain (non-instanced) tree: flatten "
                         "with instancing='off' (wide_leaf_cap <= 64 is the "
                         "build default)")
    n_nodes = wnodes.shape[0]
    nodes = wnodes.to(torch.float32).reshape(n_nodes, 16, 8).contiguous()
    blocks = wtris.to(torch.float32).contiguous()
    meta = wmeta.to(torch.int32).contiguous()
    slot_map = wslot.long() if wslot is not None else None
    if sort is None:
        sort = n_nodes > SORT_MIN_NODES
    scene_lo, inv_extent = sort_frame(nodes)

    def _segment(rays, lo, take, rt, caps, mt_cap, any_hit, keep):
        """One trace of rays [lo, lo + take) of the wave table: (results
        (t, sid, u, v) of the rt * 128 lanes, status rows (depth + 2, 8),
        level records if `keep`)."""
        dev = rays.device
        i32 = dict(dtype=torch.int32, device=dev)
        stat = torch.zeros((depth + 2, STAT_WORDS), **i32)
        stat[0, NEXT:NEXT + 1].fill_(rt)       # a fill, not a host copy
        lane = torch.arange(rt * LANES, **i32)
        pairs = torch.where(lane < take, lane + lo, -1).view(rt, LANES)
        units = torch.zeros(rt, **i32)
        mt_pairs = torch.empty(mt_cap * LANES, **i32)
        mt_units = torch.empty(mt_cap, **i32)
        levels = []
        for lvl in range(depth + 1):
            # the deepest level has no inner child: a capacity of 0 makes
            # any it finds a loss, which the status read reports
            cap_next = caps[lvl + 1] if lvl < depth else 0
            masks, counts = steps["expand"](units, stat[lvl], pairs, rays,
                                            nodes)
            pairs_next = torch.empty(max(cap_next, 1) * LANES, **i32)
            dn, base, uoff, units_next = steps["prefix"](
                units, stat[lvl], counts, meta, cap_next, mt_cap, pairs_next,
                mt_pairs, mt_units, stat[lvl + 1])
            steps["emit"](pairs, masks, stat[lvl], dn, uoff, base,
                          pairs_next, mt_pairs)
            levels.append(dict(units=units, pairs=pairs, masks=masks,
                               counts=counts, dn=dn, base=base, uoff=uoff,
                               cap=pairs.shape[0], cap_next=cap_next))
            units = units_next
            pairs = pairs_next[:max(cap_next, 1) * LANES].view(-1, LANES)
        mt = steps["mt"](mt_pairs, mt_units, stat[depth + 1], rays, blocks,
                         any_hit, mt_precision)
        res = None
        for lvl in range(depth, -1, -1):
            rec = levels[lvl]
            res = steps["bwd"](rec["masks"], stat[lvl], rec["dn"],
                               rec["uoff"], rec["base"], res, mt)
        if keep:
            levels.append(dict(mt_pairs=mt_pairs, mt_units=mt_units, mt=mt))
        return res, stat, (levels if keep else None)

    def _resized(caps, mt_cap, stat):
        """Capacities raised to what the levels of a trace reported they
        need: each level's next list, and the MT list the sum of every
        level's MT tiles."""
        rows = stat.tolist()
        caps = list(caps)
        for lvl in range(depth):
            caps[lvl + 1] = max(caps[lvl + 1], rows[lvl + 1][NEED_NEXT])
        need_mt = sum(rows[lvl + 1][NEED_MT] - rows[lvl][MT_CUR]
                      for lvl in range(depth + 1))
        mt_cap = max(mt_cap, _cdiv(need_mt, MT_WIN) * MT_WIN)
        return caps, mt_cap

    def _run(o, d, tmin, tmax, active, any_hit, keep=False):
        r = o.shape[0]
        dev = o.device
        o = o.to(torch.float32)
        d = d.to(torch.float32)
        tmin = torch.as_tensor(tmin, dtype=torch.float32,
                               device=dev).expand(r)
        tmax = torch.as_tensor(tmax, dtype=torch.float32,
                               device=dev).expand(r)
        # 1e30 is beyond any scene (bfstream.py:1015)
        tmax = torch.clamp(tmax, max=1e30)
        if active is not None:
            tmax = torch.where(active, tmax, tmin - 1.0)
        perm = None
        if sort and r >= SORT_MIN_RAYS:
            key = _ray_sort_key(o, d, scene_lo, inv_extent)
            if active is not None:
                key = torch.where(active, key, DEAD_KEY)
            perm = torch.argsort(key, stable=True)
            o, d, tmin, tmax = o[perm], d[perm], tmin[perm], tmax[perm]
        rays = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], tmin, tmax]).contiguous()
        seg = _cdiv(min(seg_rays, max(LANES, r)), LANES) * LANES
        segs = []
        for lo in range(0, r, seg):
            take = min(seg, r - lo)
            rt = _cdiv(take, LANES)
            caps, mt_cap = segment_caps(rt, depth)
            res, stat, levels = _segment(rays, lo, take, rt, caps, mt_cap,
                                         any_hit, keep)
            segs.append(dict(lo=lo, take=take, rt=rt, caps=caps,
                             mt_cap=mt_cap, res=res, stat=stat,
                             levels=levels, traces=1, rays=rays))
        # the wave's one read of its status: lost pairs -> trace again
        stats = torch.stack([s["stat"] for s in segs]).cpu() if segs else None
        for si, s in enumerate(segs):
            st = stats[si]
            while int(st[1:, LOST].sum()):
                if int(st[depth + 1, NEED_NEXT]):
                    raise ValueError(f"the tree is deeper than depth={depth}")
                if s["traces"] > depth + 2:
                    raise RuntimeError(
                        f"bf segment at ray {s['lo']} still loses "
                        f"{int(st[1:, LOST].sum())} pairs after "
                        f"{s['traces']} traces")
                s["caps"], s["mt_cap"] = _resized(s["caps"], s["mt_cap"], st)
                s["res"], s["stat"], s["levels"] = _segment(
                    rays, s["lo"], s["take"], s["rt"], s["caps"],
                    s["mt_cap"], any_hit, keep)
                s["traces"] += 1
                st = s["stat"].cpu()
            s["stat"] = st
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        t, sid, u, v = (torch.cat([s["res"][i][:s["take"]] for s in segs])
                        if segs else torch.empty(0, dtype=dt, device=dev)
                        for i, dt in enumerate(dtypes))
        if perm is not None:
            inv = torch.empty_like(perm).scatter_(
                0, perm, torch.arange(r, device=dev))
            t, sid, u, v = t[inv], sid[inv], u[inv], v[inv]
        hit = sid >= 0
        if any_hit:
            out = hit
        else:
            tri = sid
            if slot_map is not None:
                tri = torch.where(hit, slot_map[sid.clamp(min=0).long()]
                                  .to(torch.int32), -1)
            out = HitRecord(t=torch.where(hit, t, INF), tri=tri,
                            bary=torch.stack([u, v], dim=-1), hit=hit,
                            inst=None)
        return out, segs

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        return _run(o, d, tmin, tmax, active, any_hit=False)[0]

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        return _run(o, d, tmin, tmax, active, any_hit=True)[0]

    def _attach(fn, any_hit):
        def with_overflow(o, d, tmin, tmax, active=None):
            """The JAX module's overflow-reporting entry: (result, pairs
            lost). A segment that overflows is traced again with larger
            capacities, so the count is 0."""
            return _run(o, d, tmin, tmax, active, any_hit)[0], 0

        def with_levels(o, d, tmin, tmax, active=None):
            """(result, segments): per segment its rays [lo, lo + take)
            of the wave's (sorted) ray table `rays`, its capacities, how
            many times it was traced, its status rows (depth + 2, 8) on
            the host and, per level, the tensors the kernels read and
            wrote on the last trace (the last record: the MT list, its
            units and K13's results)."""
            return _run(o, d, tmin, tmax, active, any_hit, keep=True)

        fn.with_overflow, fn.with_levels = with_overflow, with_levels

    _attach(trace_closest, False)
    _attach(trace_any, True)
    return trace_closest, trace_any

