"""Copy of platinum_tpu/core/mikkt.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package. One addition: `generate_tangents_mikkt`
remembers its last results by the bytes of its inputs, because a glTF file
repeats a shared mesh once per material binding (tools/foreign_glb.py writes
the spheres scene's 49 spheres as 49 equal meshes) and this pure-Python
pass takes about a second a sphere.

MikkTSpace tangent generation (faithful reimplementation, triangles only).

The reference generates normal-mapping tangent frames with the standard
mikktspace algorithm (deps/mikkt/mikktspace.c, driven over *indexed*
vertices by src/core/mesh.cpp:135-157). The algorithm — not the code — is
reimplemented here from its published semantics so imported normal-mapped
assets shade identically:

  1. Face-vertices ("wedges") are welded by exact (position, normal, uv)
     equality.
  2. Per triangle, UV-gradient tangent/bitangent directions (vOs, vOt),
     their texel magnitudes, and the UV-winding orientation flag are
     computed; triangles with a degenerate UV map are marked
     "group-with-anything".
  3. Edge-adjacent triangles are matched (opposite winding only; each edge
     pairs at most once, ties resolved in sorted edge order).
  4. For every wedge, a connectivity group is grown by flood fill across
     shared-vertex edges with consistent orientation ("the 4 rules");
     group-with-anything triangles adopt the orientation of the first
     group that reaches them.
  5. Within a group, each face's members are the faces whose projected
     tangents agree within the angular threshold (default 180 deg — the
     whole group); each unique member set ("subgroup") gets a corner-angle-
     weighted average tangent space, projected perpendicular to the vertex
     normal.
  6. Degenerate triangles copy the tangent space of any good wedge sharing
     their welded vertex; the per-vertex result is the last write in face
     order (matching the reference's indexed-vertex usage).

Output matches the reference's `setTSpaceBasic` consumption: (V, 4) f32,
xyz = tangent, w = handedness sign (+1 if orientation-preserving else -1).

tests/test_mikkt.py verifies this implementation against the reference
mikktspace.c compiled as an external oracle (exact match on fixture
meshes).
"""

from __future__ import annotations

import math

import numpy as np

FLT_MIN = np.float32(1.1754943508222875e-38)

ORIENT = 1        # ORIENT_PRESERVING
GROUP_ANY = 2     # GROUP_WITH_ANY
DEGEN = 4         # MARK_DEGENERATE


def _not_zero(x) -> bool:
    return abs(float(x)) > float(FLT_MIN)


def _dot(a: np.ndarray, b: np.ndarray) -> np.float32:
    """f32 dot with C's left-to-right summation order."""
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _length(v: np.ndarray) -> np.float32:
    # sqrt in double of an f32 value, rounded back to f32, equals a
    # correctly-rounded f32 sqrt (no double-rounding hazard for sqrt)
    return np.float32(math.sqrt(float(_dot(v, v))))


def _normalize(v: np.ndarray) -> np.ndarray:
    if not (_not_zero(v[0]) or _not_zero(v[1]) or _not_zero(v[2])):
        return v
    return v * (np.float32(1.0) / _length(v))


def _project(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Component of v perpendicular to n, normalized (if nonzero)."""
    w = v - n * _dot(n, v)
    return _normalize(w)


_MEMO: dict = {}
_MEMO_SIZE = 8


def generate_tangents_mikkt(positions: np.ndarray, normals: np.ndarray,
                            uvs: np.ndarray, indices: np.ndarray,
                            angular_threshold_deg: float = 180.0
                            ) -> np.ndarray:
    """(V, 4) mikktspace tangents over an indexed triangle mesh; equal
    inputs (byte for byte) give a copy of the result remembered."""
    key = tuple(np.ascontiguousarray(a, t).tobytes() for a, t in (
        (positions, np.float32), (normals, np.float32), (uvs, np.float32),
        (indices, np.int64))) + (float(angular_threshold_deg),)
    if key not in _MEMO:
        if len(_MEMO) >= _MEMO_SIZE:
            del _MEMO[next(iter(_MEMO))]
        _MEMO[key] = _mikkt(positions, normals, uvs, indices,
                            angular_threshold_deg)
    return _MEMO[key].copy()


def _mikkt(positions, normals, uvs, indices, angular_threshold_deg):
    P = np.ascontiguousarray(positions, np.float32)
    N = np.ascontiguousarray(normals, np.float32)
    UV = np.ascontiguousarray(uvs, np.float32)
    I = np.ascontiguousarray(indices, np.int64).reshape(-1, 3)
    T = len(I)
    if T == 0:
        return np.zeros((len(P), 4), np.float32)
    thres_cos = math.cos(angular_threshold_deg * math.pi / 180.0)

    # --- 1. weld wedges by exact (pos, normal, uv) ------------------------
    wedge_v = I.reshape(-1)                       # (3T,) original vertex ids
    attr = np.concatenate(
        [P[wedge_v] + 0.0, N[wedge_v] + 0.0, UV[wedge_v] + 0.0], axis=1)
    # +0.0 normalizes -0.0 so bytewise equality == C float equality (no NaNs
    # expected in mesh attributes)
    keys = attr.view([("", attr.dtype)] * attr.shape[1]).reshape(-1)
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    weld = first[inverse].astype(np.int64)        # (3T,) wedge -> rep wedge
    tri_w = weld.reshape(T, 3)

    # --- 2. degenerate marking (exact position equality) ------------------
    p0, p1, p2 = P[wedge_v].reshape(T, 3, 3).transpose(1, 0, 2)
    degen = ((p0 == p1).all(1) | (p0 == p2).all(1) | (p1 == p2).all(1))
    good = np.nonzero(~degen)[0]                  # original order preserved
    n_good = len(good)

    # --- 3. per-triangle tangent directions -------------------------------
    v1 = P[I[:, 0]]
    v2 = P[I[:, 1]]
    v3 = P[I[:, 2]]
    t1, t2, t3 = (UV[I[:, k]] for k in range(3))
    t21 = t2 - t1
    t31 = t3 - t1
    d1 = v2 - v1
    d2 = v3 - v1
    area2 = t21[:, 0] * t31[:, 1] - t21[:, 1] * t31[:, 0]  # signed, x2
    vOs_raw = t31[:, 1:2] * d1 - t21[:, 1:2] * d2          # eq 18
    vOt_raw = -t31[:, 0:1] * d1 + t21[:, 0:1] * d2         # eq 19
    orient = area2 > 0
    flags = np.where(orient, ORIENT, 0).astype(np.int32)
    flags |= GROUP_ANY                                      # assumed bad
    # C Length(): sqrtf of a left-to-right f32 dot
    def _len_rows(a):
        sq = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1]) + a[:, 2] * a[:, 2]
        return np.sqrt(sq.astype(np.float64)).astype(np.float32)

    len_os = _len_rows(vOs_raw)
    len_ot = _len_rows(vOt_raw)
    fs = np.where(orient, 1.0, -1.0).astype(np.float32)
    nz_area = np.abs(area2) > FLT_MIN
    vOs = np.zeros((T, 3), np.float32)
    vOt = np.zeros((T, 3), np.float32)
    ok_s = nz_area & (len_os > FLT_MIN)
    ok_t = nz_area & (len_ot > FLT_MIN)
    vOs[ok_s] = vOs_raw[ok_s] * (fs[ok_s] / len_os[ok_s])[:, None]
    vOt[ok_t] = vOt_raw[ok_t] * (fs[ok_t] / len_ot[ok_t])[:, None]
    mag_s = np.where(nz_area, len_os / np.maximum(np.abs(area2), FLT_MIN),
                     np.float32(0.0)).astype(np.float32)
    mag_t = np.where(nz_area, len_ot / np.maximum(np.abs(area2), FLT_MIN),
                     np.float32(0.0)).astype(np.float32)
    healthy = nz_area & (mag_s > FLT_MIN) & (mag_t > FLT_MIN)
    flags[healthy] &= ~GROUP_ANY
    flags[degen] |= DEGEN

    # --- 4. neighbor matching over good triangles -------------------------
    # rank of each good tri (the reference compacts good tris to the front,
    # preserving order, and ties edge matching by that index)
    rank = np.full(T, -1, np.int64)
    rank[good] = np.arange(n_good)
    neighbors = np.full((T, 3), -1, np.int64)     # per edge i: (w[i], w[i+1])
    if n_good:
        gw = tri_w[good]                          # (G, 3)
        ea = gw
        eb = gw[:, [1, 2, 0]]
        lo = np.minimum(ea, eb).reshape(-1)
        hi = np.maximum(ea, eb).reshape(-1)
        ef = np.repeat(np.arange(n_good), 3)      # good-rank of the edge's tri
        ei = np.tile(np.arange(3), n_good)        # edge slot within the tri
        order = np.lexsort((ef, hi, lo))
        srt_lo, srt_hi = lo[order], hi[order]
        boundaries = np.nonzero(
            (srt_lo[1:] != srt_lo[:-1]) | (srt_hi[1:] != srt_hi[:-1]))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(order)]])
        fwd = (ea.reshape(-1) == lo)              # edge runs lo->hi in winding
        for s, e in zip(starts, ends):
            if e - s < 2:
                continue
            ents = order[s:e]
            for x in range(len(ents)):
                ex = ents[x]
                fx, ix = good[ef[ex]], ei[ex]
                if neighbors[fx, ix] != -1:
                    continue
                for y in range(x + 1, len(ents)):
                    ey = ents[y]
                    fy, iy = good[ef[ey]], ei[ey]
                    if fwd[ex] != fwd[ey] and neighbors[fy, iy] == -1:
                        neighbors[fx, ix] = fy
                        neighbors[fy, iy] = fx
                        break

    # --- 5. the 4-rule connectivity groups --------------------------------
    # assigned[t][i] = group id of tri t's corner i (or -1)
    assigned = np.full((T, 3), -1, np.int64)
    group_rep: list[int] = []                     # representative welded id
    group_orient: list[bool] = []
    group_faces: list[list[int]] = []

    def corner_of(t: int, rep: int) -> int:
        for i in range(3):
            if tri_w[t, i] == rep:
                return i
        return -1

    for f in good:
        if flags[f] & GROUP_ANY:
            continue
        for i in range(3):
            if assigned[f, i] != -1:
                continue
            g = len(group_rep)
            rep = int(tri_w[f, i])
            group_rep.append(rep)
            group_orient.append(bool(flags[f] & ORIENT))
            group_faces.append([int(f)])
            assigned[f, i] = g
            # preorder DFS: visit the two neighbor edges containing corner i
            stack = [int(neighbors[f, (i + 2) % 3]), int(neighbors[f, i])]
            while stack:
                t = stack.pop()
                if t < 0:
                    continue
                ci = corner_of(t, rep)
                if ci < 0 or assigned[t, ci] != -1:
                    continue
                if flags[t] & GROUP_ANY:
                    if (assigned[t] == -1).all():
                        # first group to reach it decides its orientation
                        flags[t] &= ~ORIENT
                        if group_orient[g]:
                            flags[t] |= ORIENT
                if bool(flags[t] & ORIENT) != group_orient[g]:
                    continue
                group_faces[g].append(t)
                assigned[t, ci] = g
                stack.append(int(neighbors[t, (ci + 2) % 3]))
                stack.append(int(neighbors[t, ci]))

    # --- 6. tangent spaces per group / subgroup ---------------------------
    # wedge-slot outputs, default space
    ts_os = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (3 * T, 1))
    ts_ot = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (3 * T, 1))
    ts_mag = np.ones((3 * T, 2), np.float32)
    ts_orient = np.zeros(3 * T, bool)
    ts_set = np.zeros(3 * T, bool)

    for g in range(len(group_rep)):
        rep = group_rep[g]
        faces = group_faces[g]
        n = N[wedge_v[rep]]
        proj = {t: (_project(vOs[t], n), _project(vOt[t], n))
                for t in faces}
        subgroups: list[tuple[tuple, tuple]] = []  # (members, tspace)
        for f in faces:
            pf_os, pf_ot = proj[f]
            members = []
            for t in faces:
                pt_os, pt_ot = proj[t]
                any_flag = (flags[f] | flags[t]) & GROUP_ANY
                cos_s = float(_dot(pf_os, pt_os))
                cos_t = float(_dot(pf_ot, pt_ot))
                if any_flag or f == t or (cos_s > thres_cos
                                          and cos_t > thres_cos):
                    members.append(int(t))
            members = tuple(sorted(members))
            for mem, ts in subgroups:
                if mem == members:
                    space = ts
                    break
            else:
                space = _eval_tspace(members, rep, flags, vOs, vOt,
                                     mag_s, mag_t, n, tri_w, P, wedge_v)
                subgroups.append((members, space))
            ci = corner_of(f, rep)
            w = 3 * f + ci
            s_os, s_ot, s_ms, s_mt = space
            if ts_set[w]:
                # averaged when two groups land on the same wedge (quads in
                # the reference; cannot happen for pure triangles)
                ts_os[w] = _normalize(ts_os[w] + s_os)
                ts_ot[w] = _normalize(ts_ot[w] + s_ot)
                ts_mag[w] = 0.5 * (ts_mag[w] + (s_ms, s_mt))
            else:
                ts_os[w], ts_ot[w], ts_mag[w] = s_os, s_ot, (s_ms, s_mt)
                ts_set[w] = True
            ts_orient[w] = group_orient[g]

    # --- 7. degenerate epilogue: copy a good wedge with the same weld -----
    if degen.any() and n_good:
        good_wedges = (3 * good[:, None] + np.arange(3)).reshape(-1)
        weld_of_good = weld[good_wedges]
        lookup: dict[int, int] = {}
        for wg, wd in zip(good_wedges, weld_of_good):
            lookup.setdefault(int(wd), int(wg))
        for f in np.nonzero(degen)[0]:
            for i in range(3):
                src = lookup.get(int(tri_w[f, i]))
                if src is not None:
                    w = 3 * f + i
                    ts_os[w], ts_ot[w] = ts_os[src], ts_ot[src]
                    ts_mag[w], ts_orient[w] = ts_mag[src], ts_orient[src]

    # --- 8. per-vertex output, last write in face order wins --------------
    out = np.zeros((len(P), 4), np.float32)
    sign = np.where(ts_orient, 1.0, -1.0)
    out[wedge_v, 0:3] = ts_os
    out[wedge_v, 3] = sign
    return out


def _eval_tspace(members, rep, flags, vOs, vOt, mag_s, mag_t, n,
                 tri_w, P, wedge_v):
    """Corner-angle-weighted average tangent space over member faces."""
    acc_os = np.zeros(3, np.float32)
    acc_ot = np.zeros(3, np.float32)
    acc_ms = np.float32(0.0)
    acc_mt = np.float32(0.0)
    angle_sum = np.float32(0.0)
    for f in members:
        if flags[f] & GROUP_ANY:
            continue
        i = next(k for k in range(3) if tri_w[f, k] == rep)
        p_prev = P[wedge_v[3 * f + (i + 2) % 3]]
        p_here = P[wedge_v[3 * f + i]]
        p_next = P[wedge_v[3 * f + (i + 1) % 3]]
        e1 = _project(p_prev - p_here, n)
        e2 = _project(p_next - p_here, n)
        cos = np.clip(_dot(e1, e2), np.float32(-1.0), np.float32(1.0))
        angle = np.float32(math.acos(float(cos)))
        acc_os = acc_os + angle * _project(vOs[f], n)
        acc_ot = acc_ot + angle * _project(vOt[f], n)
        acc_ms = acc_ms + angle * mag_s[f]
        acc_mt = acc_mt + angle * mag_t[f]
        angle_sum = angle_sum + angle
    acc_os = _normalize(acc_os)
    acc_ot = _normalize(acc_ot)
    if angle_sum > 0:
        acc_ms = acc_ms / angle_sum
        acc_mt = acc_mt / angle_sum
    return acc_os, acc_ot, acc_ms, acc_mt
