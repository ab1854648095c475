"""Copy of platinum_tpu/accel/tlas.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Two-level (TLAS over instanced BLAS) acceleration structure.

The reference builds one Metal BLAS per mesh plus a TLAS over instances with
per-instance transforms (renderer_pt.cpp:653-749, makeAccelStruct :244-294,
instance descriptors :702-739). The TPU equivalent keeps the packet kernel's
single flat node array and VMEM-resident triangle blocks, with the two-level
structure expressed in the data:

  * per unique mesh: an OBJECT-space 16-wide BVH (accel.wide) whose
    Möller-Trumbore coefficient blocks are stored ONCE — geometry memory is
    O(meshes), not O(instances);
  * per instance: a copy of its mesh's inner-node rows with bounds
    transformed to WORLD space (node rows are ~2 orders of magnitude smaller
    than tri blocks, and a transform edit only rewrites these rows — no
    rebuild); leaf metas carry the instance id;
  * a 16-wide TLAS over instance world AABBs whose leaf slots point at each
    instance's BLAS root — to the kernel it is all one tree;
  * per instance: a 10x10 feature-transform matrix T with
    F_object(o', d') = T @ F_world(o, d) for the MT feature vector
    F = [d, o x d, o, 1] — the MT scalars are bilinear in F and F maps
    linearly under affine instance transforms, so the kernel enters a BLAS
    leaf by ONE extra (10,10)x(10,128) matmul instead of duplicated
    geometry. t is invariant (direction is transformed unnormalized), so
    best-t culling stays world-consistent across instances.

Leaf meta encoding (extends accel.wide; inst = 0 reproduces the one-level
layout bit-for-bit): val = -meta - 2 = inst << 19 | block << 5 | n_blocks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from platinum_tpu_torch.accel.bvh import build_bvh
from platinum_tpu_torch.accel.wide import (
    BLOCK_TRIS,
    KERNEL_STACK,
    WIDTH,
    WideBVH,
    EMPTY_META,
)

F = np.float32

MAX_BLOCKS = 1 << 14     # 14-bit block ids: ~1M triangles per structure
MAX_INSTANCES = 1 << 12  # 12-bit instance ids


@dataclass
class InstancedBVH:
    nodes: np.ndarray        # (N, 128) f32 — TLAS rows, then per-instance BLAS
    meta: np.ndarray         # (N*16,) i32
    tri_blocks: np.ndarray   # (B, 10, 256) f32 — shared object-space MT blocks
    tri_of_slot: np.ndarray  # (B*64,) i64 — slot -> library triangle id
    inst_feat: np.ndarray    # (I, 10, 128) f32 — T in lanes 0..9
    inst_mesh: np.ndarray    # (I,) i64 — instance -> mesh index
    inst_node_base: np.ndarray  # (I,) i64 — first node row of each BLAS copy
    n_tlas_nodes: int
    n_instances: int

    @property
    def vmem_bytes(self) -> int:
        return (self.nodes.nbytes + self.tri_blocks.nbytes
                + self.inst_feat.nbytes)


def feature_transform(matrix: np.ndarray) -> np.ndarray:
    """(10, 10) T with F(o', d') = T @ F(o, d) for the MT feature vector
    F = [d, o x d, o, 1], where o' = B(o - t), d' = B d, B = A^-1 and
    (A, t) is the instance's object->world transform."""
    m = np.asarray(matrix, np.float64)
    a = m[:3, :3]
    t = m[:3, 3]
    if abs(np.linalg.det(a)) <= 1e-12:
        raise ValueError(
            "instance transform is singular (zero scale axis?) — the "
            "instanced path needs A^-1; flatten routes such scenes to "
            "the baked world-space path (instancing='off')")
    b = np.linalg.inv(a)
    c = -b @ t
    cx = np.array([[0, -c[2], c[1]],
                   [c[2], 0, -c[0]],
                   [-c[1], c[0], 0]])
    T = np.zeros((10, 10))
    T[0:3, 0:3] = b                              # d' = B d
    T[3:6, 0:3] = cx @ b                         # c x (B d)
    T[3:6, 3:6] = np.linalg.det(b) * a.T         # (Bo)x(Bd) = det(B) B^-T oxd
    T[6:9, 6:9] = b                              # o' = B o + c
    T[6:9, 9] = c
    T[9, 9] = 1.0
    return T.astype(F)


def transform_aabb(lo: np.ndarray, hi: np.ndarray, matrix: np.ndarray):
    """World AABB of an object-space AABB under an affine transform.
    Vectorized over leading dims of lo/hi."""
    m = np.asarray(matrix, np.float64)
    a, t = m[:3, :3], m[:3, 3]
    center = (np.asarray(lo, np.float64) + hi) * 0.5
    ext = (np.asarray(hi, np.float64) - lo) * 0.5
    wc = center @ a.T + t
    we = ext @ np.abs(a).T
    return (wc - we).astype(F), (wc + we).astype(F)


def decode_leaf_meta(meta: int):
    """Inverse of the inst<<19 | block<<5 | n_blocks leaf-meta encoding
    written (vectorized) by _write_instance_nodes."""
    val = -meta - 2
    return val >> 19, (val >> 5) & 0x3FFF, val & 31   # inst, block, n_blocks


def _object_aabb(wide: WideBVH):
    nodes = wide.nodes.reshape(-1, WIDTH, 8)
    meta = wide.meta.reshape(-1, WIDTH)
    valid = meta[0] != -1
    return (nodes[0, valid, 0:3].min(axis=0),
            nodes[0, valid, 3:6].max(axis=0))


def _wide_depth(wide: WideBVH) -> int:
    meta = wide.meta.reshape(-1, WIDTH)
    depth = np.zeros(len(meta), np.int64)
    for wid in range(len(meta)):          # parents precede children
        for c in meta[wid]:
            if c >= 0:
                depth[c] = depth[wid] + 1
    return int(depth.max(initial=0))


def _morton3(p: np.ndarray) -> np.ndarray:
    """(N, 3) unit-cube points -> 30-bit Morton codes (host-side, for
    spatial instance grouping)."""
    q = np.clip((p * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def partition_instanced(mesh_wides: list[WideBVH],
                        mesh_tri_base: list[int],
                        instances: list[tuple[int, np.ndarray]],
                        budget_bytes: int,
                        ) -> list[tuple[InstancedBVH, np.ndarray, list[int]]]:
    """Split an instanced scene whose stitched structure exceeds the VMEM
    budget into spatially-grouped sub-structures, each a standalone
    InstancedBVH over a subset of the instances.

    Instances are ordered along a Morton curve of their world-AABB centroid
    and packed greedily: spatial grouping keeps partitions compact so the
    sequential carried-best-t traversal (accel.partition) culls later ones.
    A mesh used by instances in k groups has its triangle blocks resident in
    all k (the price of spatial over per-mesh grouping; per-mesh grouping
    would make every partition overlap the whole scene and defeat culling).

    Returns [(ibvh, global_instance_ids, used_mesh_ids), ...] where ibvh's
    LOCAL instance ids i map to global ids global_instance_ids[i] (shading
    tables — InstanceTable rows/slot_mat — stay globally indexed) and
    used_mesh_ids[k] is the global mesh index of the partition's compacted
    library slot k (needed to refit the partition on a transform edit).
    """
    n_inst = len(instances)
    inst_mesh = [mi for mi, _ in instances]
    obj_bounds = {mi: _object_aabb(mesh_wides[mi]) for mi in set(inst_mesh)}
    centers = np.zeros((n_inst, 3), np.float64)
    for i, (mi, m) in enumerate(instances):
        lo, hi = transform_aabb(*obj_bounds[mi], m)
        centers[i] = (lo.astype(np.float64) + hi) * 0.5
    span = centers.max(0) - centers.min(0)
    unit = (centers - centers.min(0)) / np.where(span > 0, span, 1.0)
    order = np.argsort(_morton3(unit), kind="stable")

    # projected VMEM cost of a group: shared blocks once per unique mesh +
    # per-instance BLAS node-row copies + a TLAS row per ~8 instances +
    # per-instance feature matrices
    blk_bytes = {m: w.tri_blocks.nbytes for m, w in enumerate(mesh_wides)}
    node_bytes = {m: w.nodes.nbytes for m, w in enumerate(mesh_wides)}
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_meshes: set[int] = set()
    cur_cost = 0
    for gi in order:
        gi = int(gi)
        mi = inst_mesh[gi]
        add = node_bytes[mi] + 10 * 128 * 4 + 512 + (
            blk_bytes[mi] if mi not in cur_meshes else 0)
        if cur and cur_cost + add > budget_bytes:
            groups.append(cur)
            cur, cur_meshes, cur_cost = [], set(), 0
            # recost against the EMPTY group: the freshly-flushed
            # partition owns none of mi's shared blocks, so the stale
            # `add` would undercount by blk_bytes[mi] and let the new
            # partition blow the VMEM budget
            add = node_bytes[mi] + 10 * 128 * 4 + 512 + blk_bytes[mi]
        cur.append(gi)
        cur_meshes.add(mi)
        cur_cost += add
    if cur:
        groups.append(cur)

    parts = []
    for g in groups:
        # compact the mesh library to the meshes this group uses (keeps the
        # shared-block array — the dominant VMEM term — group-local)
        used = sorted({inst_mesh[i] for i in g})
        remap = {m: k for k, m in enumerate(used)}
        sub_wides = [mesh_wides[m] for m in used]
        sub_base = [mesh_tri_base[m] for m in used]
        sub_insts = [(remap[inst_mesh[i]], instances[i][1]) for i in g]
        ibvh = build_instanced_bvh(sub_wides, sub_base, sub_insts)
        parts.append((ibvh, np.asarray(g, np.int64), used))
    return parts


def build_instanced_bvh(mesh_wides: list[WideBVH],
                        mesh_tri_base: list[int],
                        instances: list[tuple[int, np.ndarray]]
                        ) -> InstancedBVH:
    """Assemble the flat two-level structure.

    mesh_wides: object-space WideBVH per unique mesh (block/node/tri ids all
    local to the mesh); mesh_tri_base[m]: offset of mesh m's triangles in
    the concatenated library ordering; instances: (mesh_index, 4x4
    object->world matrix) per instance.
    """
    n_inst = len(instances)
    assert n_inst >= 1
    assert n_inst < MAX_INSTANCES, f"{n_inst} instances > {MAX_INSTANCES}"

    # --- shared triangle blocks -------------------------------------------
    block_base = np.zeros(len(mesh_wides), np.int64)
    cursor = 0
    for m, w in enumerate(mesh_wides):
        block_base[m] = cursor
        cursor += len(w.tri_blocks)
    assert cursor < MAX_BLOCKS, f"{cursor} blocks > {MAX_BLOCKS}"
    tri_blocks = np.concatenate([w.tri_blocks for w in mesh_wides])
    tri_of_slot = np.concatenate([
        np.where(w.tri_of_slot >= 0, w.tri_of_slot + mesh_tri_base[m], -1)
        for m, w in enumerate(mesh_wides)
    ])

    # --- TLAS over instance world AABBs -----------------------------------
    inst_mesh = np.array([mi for mi, _ in instances], np.int64)
    mats = [np.asarray(mm, np.float64) for _, mm in instances]
    obj_bounds = [_object_aabb(mesh_wides[mi]) for mi in inst_mesh]
    wlo = np.zeros((n_inst, 3), F)
    whi = np.zeros((n_inst, 3), F)
    for i in range(n_inst):
        wlo[i], whi[i] = transform_aabb(obj_bounds[i][0], obj_bounds[i][1],
                                        mats[i])

    # binary BVH over instances: degenerate triangles (lo, hi, lo) have
    # exactly the instance AABB as bounds; max_leaf=1 -> one instance/leaf
    ib = build_bvh(wlo, whi, wlo, max_leaf=1)
    order = ib.tri_order                      # binary leaf i -> instance id

    # collapse the binary TLAS into 16-wide rows (leaf slot = instance)
    is_leaf = ib.tri_count > 0
    skip = ib.skip.astype(np.int64)

    def left(i):
        return i + 1

    def right(i):
        return int(skip[i + 1])

    tlas_rows: list[list] = []   # slots: ("inst", instance_id) / ("inner", wid)
    queue = [0]
    if bool(is_leaf[0]):
        tlas_rows.append([("inst", int(order[ib.tri_start[0]]))])
    else:
        ext = np.maximum(ib.bounds_hi - ib.bounds_lo, 0.0)
        area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                + ext[:, 2] * ext[:, 0])
        qi = 0
        queue = [0]
        wide_of_binary = {0: 0}
        tlas_rows.append(None)
        while qi < len(queue):
            b = queue[qi]
            wid = wide_of_binary[b]
            qi += 1
            cluster = [left(b), right(b)]
            while len(cluster) < WIDTH:
                cand, ca = -1, -1.0
                for k, e in enumerate(cluster):
                    if not is_leaf[e] and area[e] > ca:
                        cand, ca = k, float(area[e])
                if cand < 0:
                    break
                e = cluster.pop(cand)
                cluster.extend((left(e), right(e)))
            slots = []
            for e in cluster:
                if is_leaf[e]:
                    slots.append(("inst", int(order[ib.tri_start[e]]), e))
                else:
                    wide_of_binary[e] = len(tlas_rows)
                    tlas_rows.append(None)
                    queue.append(e)
                    slots.append(("inner", wide_of_binary[e], e))
            tlas_rows[wid] = slots
    n_tlas = len(tlas_rows)

    # --- node array assembly ----------------------------------------------
    inst_node_base = np.zeros(n_inst, np.int64)
    cursor = n_tlas
    for i in range(n_inst):
        inst_node_base[i] = cursor
        cursor += len(mesh_wides[inst_mesh[i]].nodes)
    n_nodes = cursor

    nodes = np.zeros((n_nodes, WIDTH, 8), F)
    nodes[:, :, 0:3] = 1e30
    nodes[:, :, 3:6] = -1e30
    nodes[:, :, 6] = EMPTY_META
    meta = np.full((n_nodes, WIDTH), -1, np.int32)

    # TLAS rows
    for wid, slots in enumerate(tlas_rows):
        if slots is None:
            continue
        for si, slot in enumerate(slots):
            kind, ref = slot[0], slot[1]
            if kind == "inst":
                nodes[wid, si, 0:3] = wlo[ref]
                nodes[wid, si, 3:6] = whi[ref]
                meta[wid, si] = inst_node_base[ref]
            else:
                e = slot[2]
                nodes[wid, si, 0:3] = ib.bounds_lo[e]
                nodes[wid, si, 3:6] = ib.bounds_hi[e]
                meta[wid, si] = ref
            nodes[wid, si, 6] = float(meta[wid, si])

    # per-instance BLAS copies with world-space bounds
    inst_feat = np.zeros((n_inst, 10, 128), F)
    for i in range(n_inst):
        _write_instance_nodes(nodes, meta, mesh_wides[int(inst_mesh[i])],
                              int(inst_node_base[i]),
                              int(block_base[int(inst_mesh[i])]), i, mats[i])
        inst_feat[i, :, 0:10] = feature_transform(mats[i])

    # stack worst case across the stitched tree
    tdepth = np.zeros(n_tlas, np.int64)
    for wid in range(n_tlas):             # parents precede children
        for c in meta[wid]:
            if 0 <= c < n_tlas:
                tdepth[c] = tdepth[wid] + 1
    tlas_depth = int(tdepth.max(initial=0))
    max_blas_depth = max(_wide_depth(w) for w in mesh_wides)
    worst = (tlas_depth + max_blas_depth + 2) * (WIDTH - 1) + 1
    assert worst <= KERNEL_STACK, (tlas_depth, max_blas_depth)

    return InstancedBVH(
        nodes=nodes.reshape(n_nodes, 128),
        meta=meta.reshape(-1),
        tri_blocks=tri_blocks,
        tri_of_slot=tri_of_slot,
        inst_feat=inst_feat,
        inst_mesh=inst_mesh,
        inst_node_base=inst_node_base,
        n_tlas_nodes=n_tlas,
        n_instances=n_inst,
    )


def _write_instance_nodes(nodes, meta, wide: WideBVH, node_base: int,
                          blk_base: int, inst: int, matrix: np.ndarray):
    """Fill nodes[node_base:...] with `wide`'s rows: bounds transformed to
    world space, inner metas rebased, leaf metas tagged with `inst`."""
    src_nodes = wide.nodes.reshape(-1, WIDTH, 8)
    src_meta = wide.meta.reshape(-1, WIDTH)
    n = len(src_nodes)
    valid = src_meta != -1
    lo, hi = transform_aabb(src_nodes[:, :, 0:3], src_nodes[:, :, 3:6],
                            matrix)
    dst = nodes[node_base:node_base + n]
    dmeta = meta[node_base:node_base + n]
    dst[:, :, 0:3] = np.where(valid[:, :, None], lo, 1e30)
    dst[:, :, 3:6] = np.where(valid[:, :, None], hi, -1e30)
    inner = src_meta >= 0
    leaf = src_meta <= -2
    dmeta[:] = -1
    dmeta[inner] = src_meta[inner] + node_base
    if leaf.any():
        vals = (-src_meta[leaf] - 2).astype(np.int64)
        blocks, nb = vals >> 5, vals & 31
        new_blocks = blocks + blk_base
        assert (new_blocks < MAX_BLOCKS).all()
        dmeta[leaf] = -(((inst << 19) | (new_blocks << 5) | nb) + 2)
    # float class slot: exact id for inner, -1 empty, -2 for any leaf (the
    # kernel only needs the class; full leaf values exceed exact-f32 range)
    dst[:, :, 6] = np.where(inner, dmeta.astype(F),
                            np.where(leaf, np.float32(-2.0), EMPTY_META))


def update_instance_transform(ibvh: InstancedBVH,
                              mesh_wides: list[WideBVH],
                              inst: int, matrix: np.ndarray) -> None:
    """Re-transform one instance's BLAS bounds + refit the TLAS in place —
    the O(nodes-touched) equivalent of the reference's TLAS refit on a
    transform edit (no geometry rebuild; tri blocks untouched)."""
    nodes = ibvh.nodes.reshape(-1, WIDTH, 8)
    meta = ibvh.meta.reshape(-1, WIDTH)
    m = int(ibvh.inst_mesh[inst])
    base = int(ibvh.inst_node_base[inst])
    # recompute block base of this mesh from any leaf meta? cheaper: derive
    # from the stored structure by re-walking the mesh's first leaf
    wide = mesh_wides[m]
    src_meta = wide.meta.reshape(-1, WIDTH)
    leaf = src_meta <= -2
    blk_base = 0
    if leaf.any():
        src_first = int((-src_meta[leaf][0] - 2) >> 5)
        dst_first = int(decode_leaf_meta(
            int(meta[base:base + len(src_meta)][leaf][0]))[1])
        blk_base = dst_first - src_first
    _write_instance_nodes(nodes, meta, wide, base, blk_base, inst,
                          np.asarray(matrix))
    ibvh.inst_feat[inst, :, 0:10] = feature_transform(np.asarray(matrix))

    # TLAS refit, children before parents (creation order is top-down)
    n_tlas = ibvh.n_tlas_nodes
    for wid in range(n_tlas - 1, -1, -1):
        for si in range(WIDTH):
            ref = int(meta[wid, si])
            if ref < 0:
                continue
            # inner TLAS node or an instance's BLAS root: either way the
            # slot bound is the union of the referenced node's child slots
            sub = nodes[ref]
            v = meta[ref] != -1
            if v.any():
                nodes[wid, si, 0:3] = sub[v, 0:3].min(axis=0)
                nodes[wid, si, 3:6] = sub[v, 3:6].max(axis=0)
