"""Copy of platinum_tpu/accel/wide.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

16-wide BVH for the Pallas packet-traversal kernel.

Collapses the binary SAH BVH (accel.bvh / accel.cpp) into a 16-ary tree
packed in a TPU-native layout:

  * one inner node = one (128,) f32 row = 16 child slots x 8 floats
    [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, meta0, pad]
  * one leaf BLOCK = one (10, 256) f32 tile holding the Moller-Trumbore
    *matmul coefficients* of 64 triangles: all four MT scalars are bilinear
    in the per-ray feature vector F = [d, o x d, o, 1], so a single MXU
    matmul C(10,256) . F(10,128) intersects 64 triangles against 128 rays
    (one MXU issue amortises the matmul latency over the whole leaf).
    Block columns: [det x64 | u*det x64 | v*det x64 | t*det x64]; block
    rows are the F features the column dots against.

Rows are lane-dense (full 128-float VPU rows), so the whole structure lives
in VMEM (~128 MB on v5e) — the enabling property for gather-free traversal
(see ops/pallas_trace.py). meta0 in the node rows is a *plain float*
(exact integers < 2^24 survive the MXU permutation transpose; bitcast bit
patterns would not). The kernel actually consumes metadata from the
parallel int32 `meta` table (SMEM-resident: pure scalar loads).

meta encoding (both the float row slot and the int table):
  >= 0 : inner child — index of the child's own (128,) node row
  -1   : empty slot (culled by the kernel's meta mask; its placeholder
         bounds are never trusted)
  <= -2: leaf — val = -meta - 2 = first_block * 32 + n_blocks

Triangle ids are implicit: block b's slot c holds the (BVH-ordered)
triangle b * 32 + c, so the winner's id is recovered from the block base
and the argmin slot — no id storage or gather.

The reference gets this structure for free from Metal's hardware BVH
(renderer_pt.cpp:653-749); the collapse-from-binary approach follows the
standard wide-BVH literature (Ylitie-style greedy collapse by surface
area); the MT-as-matmul factorisation is the classic Plucker/triple-product
expansion arranged for the MXU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from platinum_tpu_torch.accel.bvh import BVH

F = np.float32

# Width of an inner node (children per node) and a leaf block (tris/block)
WIDTH = 16
BLOCK_TRIS = 64
# n_blocks is encoded in 5 bits
MAX_LEAF_BLOCKS = 31
DEFAULT_LEAF_CAP = 64

# Capacities of the traversal kernel's per-packet SMEM structures
# (ops/pallas_trace.py sizes its scratch from these). build_wide_bvh
# asserts every tree it emits fits them, so a malformed build fails
# loudly at build time instead of corrupting SMEM at trace time.
KERNEL_STACK = 256   # node-id stack entries per packet
KERNEL_LEAFQ = 64    # leaf-block queue entries per packet

EMPTY_META = np.float32(-1.0)


@dataclass
class WideBVH:
    nodes: np.ndarray       # (N, 128) f32 — inner nodes, root is row 0
    tri_blocks: np.ndarray  # (B, 10, 256) f32 — MT coefficient blocks
    meta: np.ndarray        # (N*16,) i32 — per-child meta (SMEM table)
    tri_of_slot: np.ndarray  # (B*64,) i64 — slot -> BVH-ordered tri (-1 pad)
    n_tris: int             # original triangle count

    @property
    def vmem_bytes(self) -> int:
        return self.nodes.nbytes + self.tri_blocks.nbytes


def _leaf_meta(block_start: int, n_blocks: int) -> int:
    val = block_start * 32 + n_blocks
    assert 0 < n_blocks <= MAX_LEAF_BLOCKS and val < (1 << 24), (
        block_start, n_blocks)
    return -(val + 2)


def pack_tri_blocks(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    slot_tri: np.ndarray) -> np.ndarray:
    """Build (B, 10, 256) MT coefficient blocks.

    slot_tri: (B*64,) indices into v0/e1/e2 (-1 = padding slot, which gets
    an all-zero column: det == 0 is never valid).

    Derivation (o, d per ray; v0, e1, e2 per triangle; n = e2 x e1):
      det   =  d . n
      u*det = (o x d) . e2  -  d . (e2 x v0)
      v*det = -(o x d) . e1  -  d . (v0 x e1)
      t*det =  v0 . n  -  o . n
    against the per-ray feature rows F = [d(3), o x d(3), o(3), 1].
    """
    n_slots = len(slot_tri)
    assert n_slots % BLOCK_TRIS == 0
    b = n_slots // BLOCK_TRIS
    valid = slot_tri >= 0
    sel = slot_tri[valid].astype(np.int64)
    tv0 = v0[sel].astype(np.float64)
    te1 = e1[sel].astype(np.float64)
    te2 = e2[sel].astype(np.float64)
    n = np.cross(te2, te1)

    cols = np.zeros((n_slots, 4, 10), np.float64)
    cv = cols[valid]
    # det
    cv[:, 0, 0:3] = n
    # u*det
    cv[:, 1, 0:3] = -np.cross(te2, tv0)
    cv[:, 1, 3:6] = te2
    # v*det
    cv[:, 2, 0:3] = -np.cross(tv0, te1)
    cv[:, 2, 3:6] = -te1
    # t*det
    cv[:, 3, 6:9] = -n
    cv[:, 3, 9] = (tv0 * n).sum(-1)
    cols[valid] = cv

    # (B, BT, 4, 10) -> (B, 10, 4*BT) with column layout [out*BT + slot]
    blocks = cols.reshape(b, BLOCK_TRIS, 4, 10).transpose(0, 3, 2, 1)
    return np.ascontiguousarray(
        blocks.reshape(b, 10, 4 * BLOCK_TRIS)
    ).astype(F)


def build_wide_bvh(bvh: BVH, tri_geo: np.ndarray,
                   leaf_cap: int = DEFAULT_LEAF_CAP) -> WideBVH:
    """Collapse `bvh` (binary, DFS/skip layout) into the 16-wide packed form.

    `tri_geo` is the (T, >=9) f32 array of BVH-ordered triangles
    ([v0, e1, e2, ...] rows, the same ordering `bvh.tri_start` indexes).
    Leaf-block slot ids index this same ordering.
    """
    n = bvh.num_nodes
    skip = bvh.skip.astype(np.int64)
    tri_count = bvh.tri_count.astype(np.int64)
    is_leaf = tri_count > 0

    # Subtree triangle ranges: DFS order means subtree [i, skip[i]) holds the
    # contiguous triangle range [csum[i], csum[skip[i]]).
    csum = np.zeros(n + 1, np.int64)
    np.cumsum(tri_count, out=csum[1:])
    sub_start = csum[:n]
    sub_count = csum[skip] - sub_start

    ext = np.maximum(bvh.bounds_hi - bvh.bounds_lo, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def left(i):
        return i + 1

    def right(i):
        return int(skip[i + 1])

    leaf_cap = min(int(leaf_cap), MAX_LEAF_BLOCKS * BLOCK_TRIS)

    queue: list[tuple[int, int]] = []
    node_count = 0

    def new_wide(binary_idx: int) -> int:
        nonlocal node_count
        queue.append((node_count, binary_idx))
        node_count += 1
        return node_count - 1

    leaves: list[tuple[int, int]] = []   # (tri_start, tri_count) per fat leaf
    wide_rows: list[list] = []           # slot descriptors per wide node

    def is_fat_leaf(b: int) -> bool:
        return bool(is_leaf[b]) or sub_count[b] <= leaf_cap

    if is_fat_leaf(0):
        # Degenerate: whole scene is one leaf — single wide node, one slot.
        wide_rows.append([(0, "leaf", len(leaves))])
        leaves.append((int(sub_start[0]), int(sub_count[0])))
    else:
        new_wide(0)
        qi = 0
        while qi < len(queue):
            wid, b = queue[qi]
            qi += 1
            cluster = [left(b), right(b)]
            while len(cluster) < WIDTH:
                cand, cand_area = -1, -1.0
                for k, e in enumerate(cluster):
                    if not is_fat_leaf(e) and area[e] > cand_area:
                        cand, cand_area = k, float(area[e])
                if cand < 0:
                    break
                e = cluster.pop(cand)
                cluster.extend((left(e), right(e)))
            slots = []
            for e in cluster:
                if is_fat_leaf(e):
                    slots.append((e, "leaf", len(leaves)))
                    leaves.append((int(sub_start[e]), int(sub_count[e])))
                else:
                    slots.append((e, "inner", new_wide(e)))
            wide_rows.append(slots)

    # --- Pack leaf triangle blocks -----------------------------------------
    leaf_block_start = np.zeros(len(leaves), np.int64)
    leaf_n_blocks = np.zeros(len(leaves), np.int64)
    cursor = 0
    for li, (s, c) in enumerate(leaves):
        blocks = (c + BLOCK_TRIS - 1) // BLOCK_TRIS
        leaf_block_start[li] = cursor
        leaf_n_blocks[li] = blocks
        cursor += blocks
    total_blocks = max(int(cursor), 1)

    slot_tri = np.full(total_blocks * BLOCK_TRIS, -1, np.int64)
    for li, (s, c) in enumerate(leaves):
        base = leaf_block_start[li] * BLOCK_TRIS
        slot_tri[base: base + c] = np.arange(s, s + c)

    tg = np.asarray(tri_geo, F)
    tri_blocks = pack_tri_blocks(
        tg[:, 0:3], tg[:, 3:6], tg[:, 6:9], slot_tri
    )

    # --- Pack inner nodes ---------------------------------------------------
    n_wide = max(len(wide_rows), 1)
    nodes = np.zeros((n_wide, WIDTH, 8), F)
    # Empty slots carry finite placeholder bounds and are culled by the
    # meta mask in the kernel. (NaN bounds would poison the MXU permutation
    # transpose — 0 * NaN terms NaN the whole record; inverted finite
    # bounds do not cull because the slab min/max normalises the interval.)
    nodes[:, :, 0:3] = 1e30
    nodes[:, :, 3:6] = -1e30
    nodes[:, :, 6] = EMPTY_META
    meta_i32 = np.full((n_wide, WIDTH), -1, np.int32)
    for wid, slots in enumerate(wide_rows):
        for si, (b, kind, ref) in enumerate(slots):
            nodes[wid, si, 0:3] = bvh.bounds_lo[b]
            nodes[wid, si, 3:6] = bvh.bounds_hi[b]
            if kind == "inner":
                meta_i32[wid, si] = ref
            else:
                meta_i32[wid, si] = _leaf_meta(
                    int(leaf_block_start[ref]), int(leaf_n_blocks[ref])
                )
            nodes[wid, si, 6] = float(meta_i32[wid, si])

    # --- Kernel-capacity guarantees ----------------------------------------
    # The traversal kernel drains one popped node's leaf children fully per
    # superstep: per-node total leaf blocks must fit the leaf queue.
    blocks_per_node = np.zeros(n_wide, np.int64)
    for wid, slots in enumerate(wide_rows):
        for si, (b, kind, ref) in enumerate(slots):
            if kind == "leaf":
                blocks_per_node[wid] += int(leaf_n_blocks[ref])
    assert blocks_per_node.max(initial=0) <= KERNEL_LEAFQ, (
        f"leaf_cap={leaf_cap} can enqueue {blocks_per_node.max()} blocks "
        f"from one node, exceeding the kernel leaf queue ({KERNEL_LEAFQ})")
    # DFS stack worst case: (WIDTH-1) outstanding pushes per tree level.
    depth = np.zeros(n_wide, np.int64)
    for wid in range(n_wide):        # parents precede children in `queue`
        for si, (b, kind, ref) in enumerate(wide_rows[wid]):
            if kind == "inner":
                depth[ref] = depth[wid] + 1
    max_pushes = (int(depth.max(initial=0)) + 1) * (WIDTH - 1) + 1
    assert max_pushes <= KERNEL_STACK, (
        f"wide tree depth {depth.max()} may need {max_pushes} stack slots "
        f"(> kernel stack {KERNEL_STACK})")

    return WideBVH(nodes.reshape(n_wide, 128), tri_blocks,
                   meta_i32.reshape(-1), slot_tri, len(tg))


def build_octant_orders(nodes: np.ndarray) -> np.ndarray:
    """Per-(node, ray-octant) child traversal orders for near-first walks.

    For each of the 8 direction octants, children are ranked by their
    centroid's projection along the octant's sign vector; the walk pushes
    them far-to-near so the stack top is always the nearest unvisited
    subtree (Ylitie-style octant ordering, done at BUILD time — the
    runtime pays zero extra syncs because sorted packets share a single
    octant and the order is a pure SMEM scalar load).

    Returns (N*16,) int32: node n, octant o owns entries
    [(n*8+o)*2, (n*8+o)*2+1] — two words of 8 nibbles each, nibble j =
    the j-th child slot to push (farthest first). Empty slots sort
    mid-order; they are masked by the hit word at runtime.
    """
    n = len(nodes)
    rec = nodes.reshape(n, WIDTH, 8)
    cen = (rec[:, :, 0:3] + rec[:, :, 3:6]) * 0.5          # (N, 16, 3)
    out = np.zeros((n, 8, 2), np.int64)
    slots = np.arange(WIDTH, dtype=np.int64)
    for o in range(8):
        sgn = np.array([1 - 2 * (o & 1), 1 - 2 * ((o >> 1) & 1),
                        1 - 2 * ((o >> 2) & 1)], np.float32)
        proj = (cen * sgn).sum(-1)                          # (N, 16)
        order = np.argsort(-proj, axis=1, kind="stable")    # far -> near
        lo = (order[:, 0:8] << (4 * slots[0:8])).sum(1)
        hi = (order[:, 8:16] << (4 * slots[0:8])).sum(1)
        out[:, o, 0] = lo
        out[:, o, 1] = hi
    return out.reshape(-1).astype(np.int32)


def validate_wide(w: WideBVH) -> None:
    """Structural invariants (tests)."""
    nodes = w.nodes.reshape(-1, WIDTH, 8)
    meta = w.meta.reshape(-1, WIDTH)
    inner = meta >= 0
    assert (meta[inner] < len(w.nodes)).all()
    assert np.array_equal(nodes[:, :, 6], meta.astype(F))
    # every non-root inner node referenced exactly once
    refs = meta[inner].astype(np.int64)
    counts = np.bincount(refs, minlength=len(w.nodes))
    assert counts[0] == 0 and (counts[1:] == 1).all(), "tree must be a tree"
    # every tri present exactly once among leaf slots
    tids = w.tri_of_slot[w.tri_of_slot >= 0]
    assert len(np.unique(tids)) == len(tids) == w.n_tris
    leaf = meta <= -2
    vals = (-meta[leaf] - 2).astype(np.int64)
    blocks, nblocks = vals // 32, vals % 32
    assert ((blocks + nblocks) <= len(w.tri_blocks)).all()
    assert (nblocks > 0).all()
