"""Inputs that drive the leaf-pair kernel (K15) and the breadth-first
level prefix (K11), MT kernel (K13) and backward fold (K14) through their
corner cases, made from a seed with numpy, for
tests/test_torch_emulation.py (the CUDA sources on the CPU) and
tests/test_torch_gpu.py (on the card).

`pair_cases` rearranges a level's real (ray, block) pairs, sorted by
block, into the shapes the chunked K15 must get right: runs longer than a
chunk, runs of one pair, one block for every pair, and padding or ids out
of range; `tied_blocks` gives every hit an exact-t twin in the block's
other half. The oracles built on K15's per-pair code: `one_pair_runs`
puts every pair in a run of its own, so that the chunked K15 tests each
alone (`chunks_staged` says which chunks stage their blocks),
`brute_closest` reduces K15 on every (ray, block) pair to each ray's
closest hit, and `k15_of_tiles` runs K15 on the pairs of K13's MT
tiles. `prefix_level` builds one level of the breadth-first pipeline
(its units, per-child counts, the tree's child metas and the list
capacities) with a chosen number of units and distinct nodes, regions of
exactly 128 lanes among them, and capacities that fit or overflow.
`mt_cases` rearranges a real MT list (K13's input: 128-lane tiles of one
leaf block each) into full tiles, tiles of 1, 2 and 33 live lanes,
regions of several tiles of one block, neighbouring tiles of alternating
blocks, and dead lanes and block ids out of range; `bwd_level` builds one
level of K14's inputs with every child selected, none, inner and MT
children mixed and equal t under different slot ids. `expand_level` builds
one level of K10's inputs (a full level whose warps each take several
units, a count far below the capacity, dead tiles and tiles of one live
lane or of lanes 96-127 alone, ray and node ids out of range, zero
direction components, empty-slot metas) and `emit_level` one of K12's,
whose regions K11's plain version allocates (every bit set, one child in
lane 127 alone, regions in both lists, a region not taken between two
taken, many units of one node, many units past the count).
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


def chunks_staged(pair_block):
    """Whether each chunk of the chunked K15 stages its blocks: the chunks
    of csrc/stream_mt.cu `chunk_pairs`, each staging where its runs average
    kMinRun = 32 pairs or more (else its threads take the per-pair code,
    `test_pair`)."""
    b = pair_block.cpu().numpy()
    n, chunk = b.size, CHUNK
    while chunk > LANES and n < chunk * FULL_CHUNKS:
        chunk //= 2
    starts = np.r_[True, b[1:] != b[:-1]]
    return np.array([(1 + int(starts[c0 + 1:c0 + chunk].sum())) * 32
                     <= min(chunk, n - c0) for c0 in range(0, n, chunk)])


def one_pair_runs(pair_ray, pair_block, n_blocks):
    """The pairs with a padding pair (a block past the table, which
    misses) after each, so that every run holds one pair and every chunk
    takes the per-pair path; pair i sits at 2i."""
    pad = max(int(pair_block.max()), n_blocks) + 1
    ray = torch.stack([pair_ray, torch.zeros_like(pair_ray)], 1).reshape(-1)
    block = torch.stack([pair_block, torch.full_like(pair_block, pad)],
                        1).reshape(-1)
    return ray.contiguous(), block.contiguous()


def brute_closest(stream_mt, rays, blocks, tier):
    """Closest hit of every ray over every block through K15 (`stream_mt`,
    the wrapper or the emulated kernel) on every (ray, block) pair, reduced
    per ray: (t, id, u, v, tied), tied where another block gives the same
    least t. The pairs go ray by ray, so that neighbouring pairs name
    other blocks and every chunk tests each pair alone (its per-pair code,
    csrc/mt_block.cuh's block test)."""
    n, nb = rays.shape[1], blocks.shape[0]
    dev = rays.device
    pair_ray = torch.arange(n, dtype=torch.int32,
                            device=dev).repeat_interleave(nb)
    pair_block = torch.arange(nb, dtype=torch.int32, device=dev).repeat(n)
    assert nb > 1 and not chunks_staged(pair_block).any()
    t, slot, u, v = (x.view(n, nb) for x in stream_mt(
        rays, rays[7].clone(), pair_ray, pair_block, blocks, False,
        tier))
    tb, arg = t.min(dim=1)
    tied = (t == tb[:, None]).sum(dim=1) > 1
    pick = arg[:, None]
    return (tb, slot.gather(1, pick)[:, 0], u.gather(1, pick)[:, 0],
            v.gather(1, pick)[:, 0], tied)


def k15_of_tiles(stream_mt, pairs, units, count, rays, blocks, any_hit,
                 tier):
    """K15 (`stream_mt`) on the (ray, block) pairs of K13's first `count`
    MT tiles, each block id clamped into the table as K13 clamps it and
    each ray's limit its tmax, in K13's encoding (any hit: sid 0 where
    occluded)."""
    lanes = count * LANES
    block = units[:count].clamp(0, blocks.shape[0] - 1)
    t, sid, u, v = stream_mt(rays, rays[7].clone(),
                             pairs[:lanes].contiguous(),
                             block.repeat_interleave(LANES).contiguous(),
                             blocks, any_hit, tier)
    if any_hit:
        sid = torch.where(sid >= 0, 0, -1).to(torch.int32)
    return t, sid, u, v


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


EXPAND_CASES = ("full", "sparse", "dead", "clamps", "zero_dir", "empty_meta")


def _boxes(rng, n_nodes, empty=0.1):
    """(n_nodes, 16, 8) f32 node rows [lo, hi, meta, 0] of random boxes in
    [-4, 4]^3: inner children (meta >= 0), leaves (meta <= -2) and, with
    probability `empty`, empty slots (meta -1)."""
    c = rng.uniform(-4, 4, (n_nodes, CHILDREN, 3))
    h = rng.uniform(0.2, 1.5, (n_nodes, CHILDREN, 3))
    kind = rng.random((n_nodes, CHILDREN))
    meta = np.where(kind < empty, -1,
                    np.where(kind < 0.55, rng.integers(0, n_nodes,
                                                       kind.shape),
                             -((rng.integers(0, 500, kind.shape) << 5) | 1)
                             - 2))
    rows = np.concatenate([c - h, c + h, meta[..., None],
                           np.zeros((n_nodes, CHILDREN, 1))], -1)
    return rows.astype(np.float32)


def _aimed_rays(rng, n, tmax=np.inf):
    """(8, n) f32 rays from [-6, 6]^3 aimed at points of [-4, 4]^3 (so
    that many enter some box), tmin 1e-3, tmax as given."""
    o = rng.uniform(-6, 6, (n, 3))
    d = rng.uniform(-4, 4, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o.T, d.T, np.full((1, n), 1e-3),
                           np.full((1, n), tmax)]).astype(np.float32)


def expand_level(case, seed=19, big=False):
    """One level's inputs for `bfstream.bf_expand`, a dict: units (cap,)
    node ids, level (8,) [unit count, 0...], pairs (cap, 128) ray ids,
    rays (8, R), nodes (N, 16, 8); int32 / f32 CPU tensors. The units
    past the count hold live lanes of real nodes (nothing may be written
    for them). "full": every lane live and count = capacity, 100 units
    (12,000 with `big`, more than the card's warps); "sparse": 7 units of
    a capacity of 300; "dead": tiles with no live lane, one live lane, or
    live lanes in 96-127 alone; "clamps": ray ids -5, -1, R and past it
    and node ids below 0 and past the table among real ones; "zero_dir":
    rays with one or two direction components +0, -0 or below 1e-20, and
    finite tmax; "empty_meta": half the children empty slots."""
    rng = np.random.default_rng(seed + EXPAND_CASES.index(case))
    n_nodes, n_rays = 40, 700
    n, cap = {"full": (12000, 12000) if big else (100, 100),
              "sparse": (7, 300)}.get(case, (50, 50 + PAST))
    nodes = _boxes(rng, n_nodes, empty=0.5 if case == "empty_meta" else 0.1)
    rays = _aimed_rays(rng, n_rays,
                       tmax=6.0 if case == "zero_dir" else np.inf)
    units = np.repeat(rng.integers(0, n_nodes, -(-cap // 3)), 3)[:cap]
    pairs = rng.integers(0, n_rays, (cap, LANES))
    if case != "full":
        pairs[rng.random((cap, LANES)) < 0.2] = -1
    if case == "dead":
        pairs[0:10] = -1
        pairs[10:20] = -1
        pairs[np.arange(10, 20), rng.integers(0, LANES, 10)] = \
            rng.integers(0, n_rays, 10)
        pairs[20:30, :96] = -1
    if case == "clamps":
        bad = rng.random((cap, LANES))
        pairs[bad < 0.05] = -5
        pairs[(bad >= 0.05) & (bad < 0.1)] = n_rays
        pairs[(bad >= 0.1) & (bad < 0.15)] = n_rays + 1000
        units[rng.choice(n, 8, replace=False)] = -3
        units[rng.choice(n, 8, replace=False)] = n_nodes
        units[rng.choice(n, 4, replace=False)] = n_nodes + 50
    if case == "zero_dir":
        lanes = rng.choice(n_rays, n_rays // 2, replace=False)
        for i, r in enumerate(lanes):
            axes = rng.choice(3, 1 + i % 2, replace=False)
            rays[3 + axes, r] = (0.0, -0.0, 1e-25, -3e-21)[i % 4]
    level = np.zeros(8, np.int32)
    level[0] = n
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return dict(units=t(units), level=t(level), pairs=t(pairs),
                rays=torch.from_numpy(np.ascontiguousarray(rays)),
                nodes=torch.from_numpy(np.ascontiguousarray(nodes)))


EMIT_CASES = ("all16", "lane127", "both_lists", "hole", "same_node",
              "past_count")


def emit_level(case, seed=23, big=False):
    """One level's inputs for `bfstream.bf_emit`, a dict: pairs, masks
    (cap, 128), level (8,) [unit count, 0...], dn (cap,), uoff (cap, 16),
    base (cap * 16,) int32 CPU tensors, and the list sizes next_lanes,
    mt_lanes. dn, uoff and base are what `bf_prefix_plain` allocates for
    the masks' counts (children inner or leaf at random, so that regions
    lie in both lists); the units past the count have every bit set (a
    kernel that routed them would overwrite the first regions). "all16":
    every bit of every lane; "lane127": one child in lane 127 alone;
    "both_lists": random bits, 100 units (12,000 with `big`); "hole": the
    same with one region taken (base >= 0) set to -1 between two taken
    ones; "same_node": 60 units of one node, then 20 of another;
    "past_count": 6 units of a capacity of 200."""
    from platinum_tpu_torch.ops import bfstream as bf

    rng = np.random.default_rng(seed + EMIT_CASES.index(case))
    n_nodes = 30
    n = {"both_lists": 12000 if big else 100, "hole": 100, "same_node": 80,
         "past_count": 6}.get(case, 40)
    cap = 200 if case == "past_count" else n + PAST
    runs = (np.r_[np.zeros(60, int), np.ones(20, int)] if case == "same_node"
            else np.repeat(np.arange(-(-n // 4)), 4)[:n])
    ids = rng.permutation(n_nodes)
    units = np.zeros(cap, np.int64)
    units[:n] = ids[runs % n_nodes]        # neighbouring runs differ
    bits = rng.random((cap, LANES, CHILDREN))
    on = bits < {"all16": 2.0, "lane127": -1.0}.get(case, 0.3)
    if case == "lane127":
        on[np.arange(cap), 127, rng.integers(0, CHILDREN, cap)] = True
    on[n:] = True
    masks = (on.astype(np.int64) << np.arange(CHILDREN)).sum(-1)
    pairs = rng.integers(0, 100000, (cap, LANES))
    kind = rng.random((n_nodes, CHILDREN)) < 0.5
    meta = np.where(kind, rng.integers(0, n_nodes, kind.shape),
                    -((rng.integers(0, 500, kind.shape) << 5) | 1) - 2)
    counts = on.sum(1)
    counts[n:] = 0
    level = np.zeros(8, np.int32)
    level[0] = n
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    cap_next = mt_cap = CHILDREN * n + 8
    scratch = [torch.empty(cap_next * LANES, dtype=torch.int32),
               torch.empty(mt_cap * LANES, dtype=torch.int32),
               torch.empty(mt_cap, dtype=torch.int32),
               torch.zeros(8, dtype=torch.int32)]
    dn, base, uoff, _ = bf.bf_prefix_plain(t(units), t(level), t(counts),
                                           t(meta.reshape(-1)), cap_next,
                                           mt_cap, *scratch)
    assert int(scratch[3][bf.LOST]) == 0
    if case == "hole":
        taken = torch.nonzero(base >= 0).squeeze(1)
        base[taken[len(taken) // 2]] = -1
    return dict(pairs=t(pairs), masks=t(masks), level=t(level), dn=dn,
                uoff=uoff, base=base, next_lanes=cap_next * LANES,
                mt_lanes=mt_cap * LANES)
