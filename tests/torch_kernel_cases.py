"""Inputs that drive the leaf-pair kernel (K15) and the breadth-first
level prefix (K11), MT kernel (K13) and backward fold (K14) through their
corner cases, made from a seed with numpy, for
tests/test_torch_emulation.py (the CUDA sources on the CPU) and
tests/test_torch_gpu.py (on the card).

`pair_cases` rearranges a level's real (ray, block) pairs, sorted by
block, into the shapes the chunked K15 must get right: runs longer than a
chunk, runs of one pair, one block for every pair, and padding or ids out
of range; `tied_blocks` gives every hit an exact-t twin in the block's
other half. `prefix_level` builds one level of the breadth-first pipeline
(its units, per-child counts, the tree's child metas and the list
capacities) with a chosen number of units and distinct nodes, regions of
exactly 128 lanes among them, and capacities that fit or overflow.
`mt_cases` rearranges a real MT list (K13's input: 128-lane tiles of one
leaf block each) into full tiles, tiles of 1, 2 and 33 live lanes,
regions of several tiles of one block, neighbouring tiles of alternating
blocks, and dead lanes and block ids out of range; `bwd_level` builds one
level of K14's inputs with every child selected, none, inner and MT
children mixed and equal t under different slot ids.
"""

import numpy as np
import torch

CHUNK = 512       # pairs per CTA of the chunked K15 (csrc/stream_mt.cu)
FULL_CHUNKS = 528  # CTAs it keeps resident; fewer chunks halve their size
LANES = 128
CHILDREN = 16


def _runs(block):
    """(start, end) of each run of equal block ids."""
    b = np.asarray(block)
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    return list(zip(starts, np.r_[starts[1:], b.size]))


def pair_cases(pair_ray, pair_block, n_rays, n_blocks):
    """{case: (pair_ray, pair_block)} int32 CPU tensors from one level's
    sorted pairs: "real" as given; "cross_chunk" every run repeated until
    it spans more than a chunk and the list fills the card with whole
    chunks of 512; "single" the first pair of every run, so that each run
    has one pair; "one_block" the pairs of the most frequent block,
    repeated to about half that (chunks of 256); "padding" the real pairs
    behind a run of block -1, with blocks past the table at the end and
    ray ids -1 and past the wave among them."""
    pr = pair_ray.cpu().numpy().astype(np.int32)
    pb = pair_block.cpu().numpy().astype(np.int32)
    runs = _runs(pb)
    cases = {"real": (pr, pb)}
    # long enough that the kernel takes full chunks (a level that fills
    # the card: FULL_CHUNKS of them)
    grow = -(-FULL_CHUNKS * CHUNK // pb.size) + 1
    reps = [max(grow, -(-(CHUNK + 37) // (e - s))) for s, e in runs]
    cases["cross_chunk"] = (
        np.concatenate([np.tile(pr[s:e], k) for (s, e), k in zip(runs, reps)]),
        np.concatenate([np.tile(pb[s:e], k) for (s, e), k in zip(runs, reps)]))
    first = np.array([s for s, _ in runs])
    cases["single"] = (pr[first], pb[first])
    s, e = max(runs, key=lambda r: r[1] - r[0])
    k = -(-FULL_CHUNKS * CHUNK // 2 // (e - s))   # half chunks
    cases["one_block"] = (np.tile(pr[s:e], k), np.tile(pb[s:e], k))
    rng = np.random.default_rng(11)
    ray = pr.copy()
    ray[rng.random(ray.size) < 0.05] = -1
    ray[rng.random(ray.size) < 0.05] = n_rays + 3
    pad = CHUNK // 2 + 7
    cases["padding"] = (
        np.r_[rng.integers(0, n_rays, pad), ray, pr[:300]].astype(np.int32),
        np.r_[np.full(pad, -1), pb, np.full(300, n_blocks + 5)].astype(
            np.int32))
    return {k: (torch.from_numpy(np.ascontiguousarray(a, np.int32)),
                torch.from_numpy(np.ascontiguousarray(b, np.int32)))
            for k, (a, b) in cases.items()}


def tied_blocks(blocks):
    """A copy of the (B, 10, 256) blocks whose triangles 32-63 repeat
    triangles 0-31 (every output's column), so that a ray that hits one
    of the first half hits its twin at exactly the same t: the lower slot
    must win, also when a task's triangles are split over lanes."""
    out = blocks.clone().view(blocks.shape[0], 10, 4, 64)
    out[..., 32:] = out[..., :32]
    return out.view(blocks.shape)


PREFIX_CASES = ("large", "overflow", "empty", "exact128")


def prefix_level(case, seed=5):
    """One level's inputs for `bfstream.bf_prefix`: a dict with units
    (cap,), level (8,) [unit count, MT cursor, 0...], counts (cap, 16),
    meta (n_nodes * 16,), cap_next, mt_cap (all int32 CPU tensors or
    ints). "large": 5,000 units of 1,300 distinct nodes, every list large
    enough; "overflow": the same with both capacities at half of what
    the level needs, so that pairs are lost; "empty": no unit;
    "exact128": 300 one-unit nodes whose counts are 0 or 128, so that
    every region is whole tiles without a dead lane."""
    rng = np.random.default_rng(seed)
    n_nodes = 4000
    n_units, n_distinct = {"large": (5000, 1300), "overflow": (5000, 1300),
                           "empty": (0, 0), "exact128": (300, 300)}[case]
    cap = max(n_units, 1) + 64
    units = np.zeros(cap, np.int32)
    counts = np.zeros((cap, CHILDREN), np.int32)
    if n_units:
        cuts = np.sort(rng.choice(np.arange(1, n_units), n_distinct - 1,
                                  replace=False))
        lengths = np.diff(np.r_[0, cuts, n_units])
        ids = rng.integers(0, n_nodes, n_distinct)
        same = np.flatnonzero(ids[1:] == ids[:-1]) + 1
        ids[same] = (ids[same] + 1) % n_nodes   # neighbours differ
        units[:n_units] = np.repeat(ids, lengths)
        if case == "exact128":
            counts[:n_units] = LANES * (rng.random((n_units, CHILDREN)) < 0.4)
        else:
            counts[:n_units] = (rng.integers(1, LANES + 1,
                                             (n_units, CHILDREN))
                                * (rng.random((n_units, CHILDREN)) < 0.3))
        units[n_units:] = 7                    # past the count: not read
        counts[n_units:] = 99
    leaf = -((rng.integers(0, 6000, (n_nodes, CHILDREN)) << 5) | 1) - 2
    inner = rng.integers(0, n_nodes, (n_nodes, CHILDREN))
    meta = np.where(rng.random((n_nodes, CHILDREN)) < 0.5, inner, leaf)
    mt0 = 37
    # what the level needs, as K11 counts it
    need_next = need_mt = 0
    if n_units:
        first = np.flatnonzero(np.r_[True, units[1:n_units]
                                     != units[:n_units - 1]])
        per_node = np.add.reduceat(counts[:n_units].astype(np.int64), first)
        tiles = -(-per_node // LANES)
        is_inner = meta[units[first]] >= 0
        need_next = int(tiles[is_inner].sum())
        need_mt = int(tiles[~is_inner].sum())
    cap_next, mt_cap = need_next + 50, mt0 + need_mt + 50
    if case == "overflow":
        cap_next, mt_cap = need_next // 2, mt0 + need_mt // 2
    level = np.zeros(8, np.int32)
    level[0], level[1] = n_units, mt0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return dict(units=t(units), level=t(level), counts=t(counts),
                meta=t(meta.reshape(-1)), cap_next=cap_next, mt_cap=mt_cap)


def prefix_buffers(lv, device="cpu"):
    """Fresh in-place outputs of `bf_prefix` for level `lv`, every entry
    -2 (so that each write and each entry left alone shows): pairs_next,
    mt_pairs, mt_units, and the status row (zeros)."""
    full = lambda n: torch.full((n,), -2, dtype=torch.int32, device=device)
    return [full(max(lv["cap_next"], 1) * LANES), full(lv["mt_cap"] * LANES),
            full(lv["mt_cap"]), torch.zeros(8, dtype=torch.int32,
                                            device=device)]


def prefix_args(lv, bufs, device="cpu"):
    """bf_prefix's arguments for level `lv` with outputs `bufs`."""
    return (lv["units"].to(device), lv["level"].to(device),
            lv["counts"].to(device), lv["meta"].to(device), lv["cap_next"],
            lv["mt_cap"], *bufs)


def same_prefix(a, bufs_a, b, bufs_b, n):
    """Two runs of bf_prefix agree: dn and uoff over the n units, base
    over the distinct nodes' entries, the next level's unit table over
    its tiles, and the whole of every buffer written in place and the
    status row. Returns the list of what differs."""
    nd, nn = int(bufs_a[3][7]), int(bufs_a[3][0])
    bad = [name for name, x, y in (
        ("dn", a[0][:n], b[0][:n]), ("uoff", a[2][:n], b[2][:n]),
        ("base", a[1][:nd * CHILDREN], b[1][:nd * CHILDREN]),
        ("units_next", a[3][:nn], b[3][:nn]),
        ("pairs_next", bufs_a[0], bufs_b[0]),
        ("mt_pairs", bufs_a[1], bufs_b[1]),
        ("mt_units", bufs_a[2], bufs_b[2]), ("stat", bufs_a[3], bufs_b[3]))
        if not torch.equal(x.cpu(), y.cpu())]
    return bad


MT_CASES = ("real", "full", "sparse", "one_block", "alternating", "dead",
            "tied")
PAST = 2          # tiles / units past the count in every K13 / K14 case


def mt_cases(mt_pairs, mt_units, n, n_rays, n_blocks, seed=13):
    """{case: (mt_pairs (cap * 128,), mt_units (cap,), count)} int32 CPU
    tensors from a real MT list of n tiles, each with PAST tiles past the
    count (live lanes of a real block, which K13 must not write): "real"
    and "tied" (for `tied_blocks`) as given; "full" one tile of 128 live
    lanes; "sparse" tiles of 1, 2 and 33 live lanes at random places (odd
    task tails, the split path); "one_block" five full tiles and one of
    37 live lanes of the most frequent block (a region staged once);
    "alternating" tiles of two blocks in turn; "dead" the real list with
    ray ids -1 and past the wave in some lanes and block ids -5 and past
    the table in some tiles (clamped as the reference clamps them)."""
    rng = np.random.default_rng(seed)
    pairs = mt_pairs[:n * LANES].cpu().numpy().reshape(n, LANES).astype(
        np.int32)
    units = mt_units[:n].cpu().numpy().astype(np.int32)
    live = (pairs >= 0) & (pairs < n_rays)
    rays_of = {}
    for t in range(n):
        rays_of.setdefault(int(units[t]), []).extend(pairs[t][live[t]])
    by_size = sorted(rays_of, key=lambda b: -len(rays_of[b]))
    a, b = by_size[0], by_size[1]

    def tile(block, k, spread=False):
        """One tile of block `block` with k live lanes (its rays cycled),
        at the front or at random places."""
        src = np.resize(np.asarray(rays_of[block], np.int32), k)
        row = np.full(LANES, -1, np.int32)
        at = np.sort(rng.choice(LANES, k, replace=False)) if spread \
            else np.arange(k)
        row[at] = src
        return row, block

    cases = {"real": (pairs, units), "tied": (pairs, units)}
    cases["full"] = [tile(a, LANES)]
    cases["sparse"] = [tile(by_size[i % len(by_size)], k, spread=True)
                       for i, k in enumerate((1, 2, 33) * 8)]
    cases["one_block"] = [tile(a, LANES)] * 5 + [tile(a, 37)]
    cases["alternating"] = [tile((a, b)[i % 2], 100 - 7 * i)
                            for i in range(8)]
    dead = pairs.copy()
    dead[rng.random(dead.shape) < 0.05] = -1
    dead[rng.random(dead.shape) < 0.05] = n_rays + 3
    bad = units.copy()
    bad[rng.choice(n, max(2, n // 10), replace=False)] = -5
    bad[rng.choice(n, max(2, n // 10), replace=False)] = n_blocks + 7
    cases["dead"] = (dead, bad)
    out = {}
    extra = np.stack([tile(a, LANES)[0]] * PAST)
    for name, case in cases.items():
        if isinstance(case, list):
            case = (np.stack([row for row, _ in case]),
                    np.array([blk for _, blk in case], np.int32))
        p, u = case
        count = p.shape[0]
        p = np.concatenate([p, extra]).reshape(-1)
        u = np.r_[u, np.full(PAST, a, np.int32)]
        out[name] = (torch.from_numpy(np.ascontiguousarray(p, np.int32)),
                     torch.from_numpy(np.ascontiguousarray(u, np.int32)),
                     count)
    return out


BWD_CASES = ("synthetic",)


def bwd_level(seed=17):
    """One synthetic level of K14's inputs, a dict: masks (cap, 128), level
    (8,) [unit count, 0...], dn (cap,), uoff (cap, 16), base (cap * 16,)
    int32, and child / mt results (t, sid, u, v) of (tiles + 8) * 128
    lanes each, as misses (+inf, -1, 0, 0) or hits at t in {1, 2, 3}
    with random slot ids, so that many children tie in t and the slot id
    decides. 40 units of 12 distinct nodes, PAST units past the count;
    units 0-3 select every child on every lane, units 4-7 none, the rest
    random children; regions are missing (-1), inner or in the MT list
    (| MT_TAG), mixed in each node."""
    rng = np.random.default_rng(seed)
    n, nd, tiles = 40, 12, 20
    cap = n + PAST
    masks = rng.integers(0, 1 << CHILDREN, (cap, LANES)) & rng.integers(
        0, 1 << CHILDREN, (cap, LANES))
    masks[0:4] = (1 << CHILDREN) - 1
    masks[4:8] = 0
    dn = np.sort(rng.integers(0, nd, cap))
    dn[n:] = 0
    pick = rng.random((nd, CHILDREN))
    region = rng.integers(0, tiles, (nd, CHILDREN))
    base = np.where(pick < 0.15, -1, np.where(pick < 0.55, region,
                                              (1 << 30) | region))
    base = np.r_[base.reshape(-1), np.full((cap - nd) * CHILDREN, -1)]
    uoff = rng.integers(0, 3 * LANES, (cap, CHILDREN))

    def results():
        m = (tiles + 8) * LANES
        hit = rng.random(m) < 0.7
        t = np.where(hit, rng.integers(1, 4, m), np.inf).astype(np.float32)
        sid = np.where(hit, rng.integers(0, 500, m), -1).astype(np.int32)
        u = np.where(hit, rng.random(m), 0).astype(np.float32)
        v = np.where(hit, rng.random(m), 0).astype(np.float32)
        return tuple(torch.from_numpy(x) for x in (t, sid, u, v))

    level = np.zeros(8, np.int32)
    level[0] = n
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))
    return dict(masks=t(masks), level=t(level), dn=t(dn), uoff=t(uoff),
                base=t(base), child=results(), mt=results())
