"""The plain reference: the program's path-tracing estimator, written again
in plain PyTorch and NumPy from the scene arrays of portbench/scenes.py.

It imports nothing of the program and takes none of its derived data: the
world-space triangles, the camera constants, the material rows, the
per-material GGX energy rows (from a frozen copy of the four LUTs it
reads, ggx_energy.npz), the emissive-triangle table with its alias pick
and the Halton sampler are all worked out here again. It traces by brute
force over instance bounding boxes (no BVH) and covers the lobes the
benchmark's scenes use: opaque dielectric (GGX + energy-compensated
diffuse) and metal, multiscatter on, area lights with NEE and MIS (none
at all gives a black image), no environment, textures, transmission,
clearcoat or anisotropy; a scene with any of those is refused.

`radiance` is the entry the harness and the control call (compare.py
names its arguments). A configuration that needs more brings its own
reference module beside this one, with the same entry, and may import
this module's parts (the scene compile, the light table, the sampler,
GGX and the energy rows, the tracer).

One thing is taken from the program, and checked: the order of its
emissive triangles, which its BVH build sets and which decides the light a
sample picks. `match_lights` finds the program's rows among the
reference's own emissive triangles and the reference rebuilds the table
over that order (PERF.md says so).

Each (pixel, sample index) pair is a lane that runs the program's bounce
loop alone: the sampler draws the same dimensions per bounce, Russian
roulette, MIS and NEE follow the same formulas, so a lane's radiance
agrees with the program's to rounding unless rounding sends the path
another way. `dtype` sets the precision of everything but the sampler's
integer hashing: float32 is the reference, bfloat16 the control.
"""

from __future__ import annotations

import os

import numpy as np
import torch

RAY_EPS = 1e-3
MIN_COS = 1.5e-3
K_ENERGY = 64
MASK32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.float32(1.0 - 2 ** -24))
SAMPLE_REFLECTED, SAMPLE_TRANSMITTED = 1, 2
SAMPLE_DIFFUSE, SAMPLE_GLOSSY, SAMPLE_SPECULAR, SAMPLE_EMITTED = 4, 8, 16, 32
ENERGY_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "ggx_energy.npz")
MATERIAL_DEFAULTS = dict(base_color=(0.8, 0.8, 0.8, 1.0), emission=(0, 0, 0),
                         emission_strength=1.0, roughness=1.0, metallic=0.0,
                         transmission=0.0, ior=1.5, anisotropy=0.0,
                         clearcoat=0.0)


# ---------------------------------------------------------------------------
# Host-side scene compile (numpy)
# ---------------------------------------------------------------------------

def _bt709_identity() -> np.ndarray:
    """The BT.709 -> BT.709 matrix as the RGB <-> XYZ derivation gives it
    in float32 (the identity up to rounding)."""
    def xyz(xy):
        return np.array([xy[0], xy[1], 1.0 - xy[0] - xy[1]], np.float64)
    prim = np.stack([xyz((0.64, 0.33)), xyz((0.30, 0.60)),
                     xyz((0.15, 0.06))], axis=1)
    w = xyz((0.3127, 0.3290))
    to_xyz = prim * np.linalg.solve(prim, w / w[1])[None, :]
    from_xyz = np.linalg.inv(to_xyz).astype(np.float32)
    return (from_xyz @ to_xyz.astype(np.float32)).astype(np.float32)


def _trs(t, r, s) -> np.ndarray:
    """T . Ry . Rx . Rz . S in float64 (Euler angles in radians)."""
    (cx, cy, cz), (sx, sy, sz) = np.cos(r), np.sin(r)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = ry @ rx @ rz @ np.diag(s)
    m[:3, 3] = t
    return m


def _axis_np(coord, n):
    x = np.clip(np.asarray(coord, np.float64) * n - 0.5, 0.0, n - 1.0)
    x0 = np.floor(x)
    return x0.astype(np.int64), np.minimum(x0 + 1, n - 1).astype(np.int64), \
        x - x0


def _lerp1(lut, u):
    i0, i1, f = _axis_np(u, lut.shape[0])
    return lut[i0] * (1 - f) + lut[i1] * f


def _lerp2(lut, u, v):
    """lut (H, W) indexed [v, u], clamp-to-edge texel-centred filtering."""
    h, w = lut.shape
    x0, x1, fx = _axis_np(u, w)
    y0, y1, fy = _axis_np(v, h)
    return ((lut[y0, x0] * (1 - fx) + lut[y0, x1] * fx) * (1 - fy)
            + (lut[y1, x0] * (1 - fx) + lut[y1, x1] * fx) * fy)


def _lerp3(lut, u, v, w_):
    d = lut.shape[0]
    z0, z1, fz = _axis_np(w_, d)
    return _lerp2(lut[z0], u, v) * (1 - fz) + _lerp2(lut[z1], u, v) * fz


def alias_table(weights: np.ndarray):
    """(p, alias) of Vose's method over `weights`, small and large slots
    popped lowest index first."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    scaled = w * (n / w.sum())
    p = np.ones(n)
    alias = np.arange(n)
    work = scaled.copy()
    small = list(np.nonzero(scaled < 1.0)[0][::-1])
    large = list(np.nonzero(scaled >= 1.0)[0][::-1])
    while small and large:
        lo, hi = small.pop(), large.pop()
        p[lo], alias[lo] = work[lo], hi
        work[hi] = (work[hi] + work[lo]) - 1.0
        (small if work[hi] < 1.0 else large).append(hi)
    return p.astype(np.float32), alias


def compile_scene(arrays: dict, width: int, height: int) -> dict:
    """World-space triangle tables, per-instance ranges and bounds,
    material rows with their GGX energy rows, the emissive triangles and
    the camera constants, as numpy arrays."""
    f32 = np.float32
    env = arrays.get("environment")
    if arrays.get("textures") or (env is not None and (
            env.get("texture") is not None
            or max(env["constant_color"]) * env["strength"] > 0)):
        raise ValueError("the reference covers scenes without textures or "
                         "a lit environment only")
    mat_names = list(arrays["materials"])
    mats = [dict(MATERIAL_DEFAULTS, **arrays["materials"][k])
            for k in mat_names]
    for m in mats:
        if (m["transmission"] or m["anisotropy"] or m["clearcoat"]
                or m.get("textures") or (m["roughness"] ** 2 < 1e-3)):
            raise ValueError("the reference covers opaque rough dielectric "
                             "and metal lobes only")
    idt = _bt709_identity()
    albedo = np.stack([idt @ np.asarray(m["base_color"], f32)[:3]
                       for m in mats]).astype(f32)
    emission = np.stack([(idt @ np.asarray(m["emission"], f32))
                         * f32(m["emission_strength"]) for m in mats])
    emissive = np.array([max(m["emission"]) > 0 and m["emission_strength"] > 0
                         for m in mats])
    rough = np.array([m["roughness"] for m in mats], f32)
    metal = np.array([m["metallic"] for m in mats], f32)
    ior = np.array([m["ior"] for m in mats], f32)
    lut = np.load(ENERGY_FILE)
    cos_grid = (np.arange(K_ENERGY, dtype=np.float64) + 0.5) / K_ENERGY
    energy = np.zeros((len(mats), K_ENERGY, 2), f32)
    energy_avg = np.zeros((len(mats), 2), f32)
    for k in range(len(mats)):
        rg, io = float(rough[k]), float(ior[k])
        iorp = (io - 1.0) / max(io, 1e-6)
        energy[k, :, 0] = _lerp2(lut["E"], cos_grid, rg)
        energy[k, :, 1] = _lerp3(lut["E_ms"], cos_grid, rg, iorp)
        energy_avg[k, 0] = _lerp1(lut["E_avg"], rg)
        energy_avg[k, 1] = _lerp2(lut["E_ms_avg"], iorp, rg)

    v0s, e1s, e2s, nrm, tan, tmat, starts, counts, los, his = \
        [], [], [], [], [], [], [], [], [], []
    start = 0
    for _name, mesh_key, mat_key, t, r, s in arrays["instances"]:
        mesh = arrays["meshes"][mesh_key]
        m = _trs(t, r, s)
        lin = m[:3, :3]
        wp = (mesh["positions"].astype(np.float64) @ lin.T
              + m[:3, 3]).astype(f32)
        wn = mesh["normals"].astype(np.float64) @ np.linalg.inv(lin)
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-12)
        wt = mesh["tangents"][:, :3].astype(np.float64) @ lin.T
        wt /= np.maximum(np.linalg.norm(wt, axis=-1, keepdims=True), 1e-12)
        idx = mesh["indices"].astype(np.int64)
        v0 = wp[idx[:, 0]]
        v0s.append(v0)
        e1s.append(wp[idx[:, 1]] - v0)
        e2s.append(wp[idx[:, 2]] - v0)
        nrm.append(np.concatenate([wn[idx[:, k]] for k in range(3)],
                                  -1).astype(f32))
        tan.append(np.concatenate([wt[idx[:, 0]],
                                   mesh["tangents"][idx[:, 0], 3:4]],
                                  -1).astype(f32))
        tmat.append(np.full(len(idx), mat_names.index(mat_key), np.int64))
        starts.append(start)
        counts.append(len(idx))
        start += len(idx)
        los.append(wp.min(0))
        his.append(wp.max(0))
    lo, hi = np.stack(los), np.stack(his)
    pad = 1e-4 * (np.abs(lo) + np.abs(hi)) + 1e-4
    tri_mat = np.concatenate(tmat)
    cam = arrays["camera"]
    pos = np.asarray(cam["position"], np.float64)
    tgt = np.asarray(cam["target"], np.float64)
    w = (pos - tgt) / np.linalg.norm(pos - tgt)
    up = (np.array([0.0, 0.0, 1.0]) if pos[0] == tgt[0] and pos[2] == tgt[2]
          else np.array([0.0, 1.0, 0.0]))
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    aspect = width / height
    sensor = cam["sensor_size"]
    vh = (cam["focus_distance"] * (sensor[0] / max(sensor[0] / sensor[1],
                                                   aspect))
          / cam["focal_length"])
    vu, vv = u * vh * aspect, -v * vh
    top_left = pos - cam["focus_distance"] * w - (vu + vv) * 0.5
    return dict(
        v0=np.concatenate(v0s), e1=np.concatenate(e1s),
        e2=np.concatenate(e2s), normals=np.concatenate(nrm),
        tangents=np.concatenate(tan), tri_mat=tri_mat,
        inst_start=np.array(starts), inst_count=np.array(counts),
        inst_lo=(lo - pad).astype(f32), inst_hi=(hi + pad).astype(f32),
        albedo=albedo, emission=emission.astype(f32), emissive=emissive,
        rough=rough, metal=metal, ior=ior, energy=energy,
        energy_avg=energy_avg,
        light_tris=np.nonzero(emissive[tri_mat])[0],
        cam_pos=pos.astype(f32), cam_top_left=top_left.astype(f32),
        cam_du=(vu / width).astype(f32), cam_dv=(vv / height).astype(f32),
        width=width, height=height)


def match_lights(scene: dict, program_rows: np.ndarray):
    """The program's emissive-triangle order: for each row (v0, e1, e2) of
    the program's light table, the reference's emissive triangle with the
    same corners. Returns (triangle ids in the program's order, the
    widest corner gap, 0 with no emissive triangle); raises unless the
    rows are a permutation of the reference's emissive triangles."""
    lt = scene["light_tris"]
    ours = np.concatenate([scene["v0"][lt], scene["e1"][lt], scene["e2"][lt]],
                          -1).astype(np.float64)
    theirs = np.asarray(program_rows, np.float64)[:, :9]
    if theirs.shape[0] != len(lt):
        raise ValueError(f"the program has {theirs.shape[0]} emissive "
                         f"triangles, the reference {len(lt)}")
    if len(lt) == 0:
        return lt, 0.0
    gap = np.abs(theirs[:, None, :] - ours[None, :, :]).max(-1)
    pick = gap.argmin(1)
    if len(np.unique(pick)) != len(lt):
        raise ValueError("the program's light rows are not a permutation of "
                         "the scene's emissive triangles")
    return lt[pick], float(gap[np.arange(len(pick)), pick].max())


def light_table(scene: dict, order: np.ndarray) -> np.ndarray:
    """(L, 16) rows [v0 e1 e2 emission area p_light alias_p alias] over
    the emissive triangles in `order`, and their total power (L may be
    0)."""
    if len(order) == 0:
        return np.zeros((0, 16), np.float32), np.float32(0.0)
    v0, e1, e2 = scene["v0"][order], scene["e1"][order], scene["e2"][order]
    le = scene["emission"][scene["tri_mat"][order]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    power = le[:, 1] * area * np.pi
    total = float(np.cumsum(power, dtype=np.float64).astype(np.float32)[-1])
    p, alias = alias_table(power)
    rows = np.zeros((len(order), 16), np.float32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12] = v0, e1, e2, le
    rows[:, 12] = area
    rows[:, 13] = power / max(total, 1e-20)
    rows[:, 14] = p
    rows[:, 15] = alias
    return rows, np.float32(total)


# ---------------------------------------------------------------------------
# Sampler: Halton over a PCG4D-hashed per-(pixel, sample) index
# ---------------------------------------------------------------------------

def _primes(n):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


PRIMES = _primes(512)


def _pcg4d_x(x, y, z, w):
    x, y, z, w = ((a * 1664525 + 1013904223) & MASK32 for a in (x, y, z, w))
    for k in range(2):
        x = (x + y * w) & MASK32
        y = (y + z * x) & MASK32
        z = (z + x * y) & MASK32
        w = (w + y * z) & MASK32
        if k == 0:
            x, y, z, w = (a ^ (a >> 16) for a in (x, y, z, w))
    return x


def _digit_weights(base):
    inv, f, reach, out = np.float32(1.0) / np.float32(base), np.float32(1.0), 1, []
    while reach <= MASK32 and len(out) < 32:
        f = np.float32(f * inv)
        out.append(float(f))
        reach *= base
    return out


class Halton:
    """Dimension `dim` of lane i is the radical inverse of offset[i] in
    the dim-th prime base, accumulated digit by digit in float32."""

    def __init__(self, px, py, s):
        self.offset = _pcg4d_x(px, py, s, (px + py) & MASK32)
        self.dim = 0

    def next(self, k=1):
        out = []
        for _ in range(k):
            base = PRIMES[self.dim]
            i = self.offset
            r = torch.zeros(i.shape, dtype=torch.float64, device=i.device)
            for f in _digit_weights(base):
                r = (torch.remainder(i, base).double() * f + r).float().double()
                i = torch.div(i, base, rounding_mode="floor")
            out.append(torch.clamp(r.float(), max=ONE_MINUS_EPS))
            self.dim += 1
        return out[0] if k == 1 else torch.stack(out, -1)


# ---------------------------------------------------------------------------
# Vector helpers, GGX, Fresnel
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)),
                           min=1e-20)


def _flip(neg, like):
    """-1 where `neg`, else 1, in `like`'s dtype."""
    return torch.where(neg, -1.0, 1.0).to(like.dtype)


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device).expand(
        like.shape)


def _mdf(a, w):
    cos2 = w[..., 2] * w[..., 2]
    k = (w[..., 0] * w[..., 0] / (a * a) + w[..., 1] * w[..., 1] / (a * a)
         ) / torch.clamp(cos2, min=1e-20)
    k = (1.0 + k) * (1.0 + k)
    return 1.0 / (np.pi * a * a * torch.clamp(cos2 * cos2 * k, min=1e-20))


def _lambda(a, w):
    cos2 = torch.clamp(w[..., 2] * w[..., 2], min=1e-20)
    return (torch.sqrt(1.0 + a * a / cos2) - 1.0) * 0.5


def _g(a, wo, wi):
    return 1.0 / (1.0 + _lambda(a, wo) + _lambda(a, wi))


def _ggx_pdf(a, wo, wm):
    vis = (1.0 / (1.0 + _lambda(a, wo))
           / torch.clamp(torch.abs(wo[..., 2]), min=1e-20)
           * _mdf(a, wm) * torch.abs(_dot(wo, wm)))
    return vis / torch.clamp(4.0 * torch.abs(_dot(wo, wm)), min=1e-20)


def _single_scatter(a, wo, wi, wm):
    return _mdf(a, wm) * _g(a, wo, wi) / torch.clamp(
        4.0 * torch.abs(wo[..., 2]) * torch.abs(wi[..., 2]), min=1e-20)


def _sample_vndf(a, w, u):
    """Visible normal by the spherical-cap method."""
    wh = _normalize(torch.stack([w[..., 0] * a, w[..., 1] * a, w[..., 2]], -1))
    wh = wh * _flip(wh[..., 2:3] < 0.0, wh)
    b_raw = _cross(_const([0.0, 0.0, 1.0], wh), wh)
    b_len = torch.sqrt(torch.sum(b_raw * b_raw, -1, keepdim=True))
    b = torch.where(wh[..., 2:3] < 0.9999,
                    b_raw / torch.clamp(b_len, min=1e-20),
                    _const([1.0, 0.0, 0.0], wh))
    t = _cross(wh, b)
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * np.pi * u[..., 1]
    p0, p1 = r * torch.cos(theta), r * torch.sin(theta)
    h = torch.sqrt(torch.clamp(1.0 - p0 * p0, min=0.0))
    mix = 0.5 * wh[..., 2] + 0.5
    py = h * (1.0 - mix) + p1 * mix
    pz = torch.sqrt(torch.clamp(1.0 - p0 ** 2 - py ** 2, min=0.0))
    nh = b * p0[..., None] + t * py[..., None] + wh * pz[..., None]
    return _normalize(torch.stack([a * nh[..., 0], a * nh[..., 1],
                                   torch.clamp(nh[..., 2], min=1e-6)], -1))


def _reflect(i, n):
    return i - 2.0 * torch.sum(i * n, dim=-1, keepdim=True) * n


def _schlick(f0, cos):
    k = 1.0 - torch.clamp(cos, 0.0, 1.0)
    k2 = k * k
    return f0 + (1.0 - f0) * (k2 * k2 * k)[..., None]


def _fresnel(cos, ior):
    cos = torch.clamp(cos, 0.0, 1.0)
    sin2_t = (1.0 - cos * cos) / torch.clamp(ior * ior, min=1e-20)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    par = (ior * cos - cos_t) / torch.clamp(ior * cos + cos_t, min=1e-20)
    per = (cos - ior * cos_t) / torch.clamp(cos + ior * cos_t, min=1e-20)
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (par * par + per * per))


# ---------------------------------------------------------------------------
# The BSDF: opaque dielectric (GGX + diffuse) and metal, energy rows on
# ---------------------------------------------------------------------------

class Bsdf:
    def __init__(self, tables, mat):
        self.t = tables
        self.mat = mat
        self.albedo = tables["albedo"][mat]
        self.rough = tables["rough"][mat]
        self.metal = tables["metal"][mat]
        self.ior = tables["ior"][mat]
        self.alpha = self.rough * self.rough
        self.avg = tables["energy_avg"][mat]

    def _row(self, cos, col):
        rows = self.t["energy"]
        m, k = rows.shape[0], rows.shape[1]
        x = torch.clamp(cos * k - 0.5, 0.0, k - 1.0)
        x0 = torch.floor(x)
        f = x - x0
        lin = self.mat * k + x0.long().clamp(0, k - 1)   # NaN-safe
        flat = rows.reshape(m * k, 2)
        r0 = flat[lin]
        r1 = flat[torch.clamp(lin + 1, max=m * k - 1)]
        return (r0 * (1.0 - f[..., None]) + r1 * f[..., None])[..., col]

    def _multiscatter(self, wo_z, wi_z, f_avg):
        s = _flip(wo_z < 0.0, wo_z)
        wo_z, wi_z = wo_z * s, wi_z * s
        e_wo, e_wi, e_avg = self._row(wo_z, 0), self._row(wi_z, 0), \
            self.avg[:, 0]
        ms = (1.0 - e_wo) * (1.0 - e_wi) / (
            np.pi * torch.clamp(1.0 - e_avg, min=1e-5))
        if f_avg.dim() == 2:
            e_avg, ms = e_avg[:, None], ms[:, None]
        return f_avg * f_avg * e_avg / torch.clamp(
            1.0 - f_avg * (1.0 - e_avg), min=1e-5) * ms

    def _diffuse(self, wo_z, wi_z):
        s = _flip(wo_z < 0.0, wo_z)
        wo_z, wi_z = wo_z * s, wi_z * s
        return (1.0 - self._row(wo_z, 1)) * (1.0 - self._row(wi_z, 1)) / (
            np.pi * torch.clamp(1.0 - self.avg[:, 1], min=1e-5))

    def _f_avg(self):
        return (self.ior - 1.0) / (4.08567 + 1.00071 * self.ior)

    def _pick_dielectric(self, wo_z, f_avg):
        row_e, row_ms = self._row(torch.abs(wo_z), 0), \
            self._row(torch.abs(wo_z), 1)
        fms = f_avg * f_avg * row_e / torch.clamp(
            1.0 - f_avg * (1.0 - row_e), min=1e-5)
        return torch.clamp(f_avg * row_ms + fms * (1.0 - row_ms), 0.0, 0.999)

    def emitted(self, tables):
        p_opaque = (1.0 - 0.0) * (1.0 - self.metal) * (1.0 - 0.0)
        em = tables["emission"][self.mat]
        return torch.where(tables["emissive"][self.mat][:, None],
                           em * p_opaque[:, None], 0.0)

    def wants_nee(self):
        return (self.rough > 0.0) | (self.metal + 0.0 < 1.0)

    def evaluate(self, wo, wi):
        a, m = self.alpha, self.metal
        valid = (wo[..., 2] >= MIN_COS) & (wi[..., 2] >= MIN_COS)
        opaque = (1.0 - m) * (1.0 - (1.0 - m) * 0.0)
        wm = wo + wi
        wm_len = torch.sqrt(torch.sum(wm * wm, -1, keepdim=True))
        wm = wm / torch.clamp(wm_len, min=1e-20)
        wm = wm * _flip(wm[..., 2:3] < 0, wm)
        wm_ok = wm_len[..., 0] > 1e-10
        dwm = torch.abs(_dot(wo, wm))
        ss = _single_scatter(a, wo, wi, wm)
        gpdf = _ggx_pdf(a, wo, wm)
        f_metal = _schlick(self.albedo, dwm) * ss[..., None] + \
            self._multiscatter(wo[..., 2], wi[..., 2],
                               (20.0 * self.albedo + 1.0) / 21.0)
        use_metal = (m > 0.0) & wm_ok
        f = torch.zeros_like(wo) + torch.where(use_metal[..., None],
                                               f_metal * m[..., None], 0.0)
        pdf = torch.zeros_like(m) + torch.where(use_metal, gpdf * m, 0.0)
        f_avg = self._f_avg()
        bf = self._pick_dielectric(wo[..., 2], f_avg)
        c_diff = self._diffuse(wo[..., 2], wi[..., 2])
        diel = _fresnel(dwm, self.ior) * ss + self._multiscatter(
            wo[..., 2], wi[..., 2], f_avg)
        f_op = diel[..., None] + self.albedo * c_diff[..., None]
        pdf_op = gpdf * bf + torch.abs(wi[..., 2]) / np.pi * (1.0 - bf)
        use_op = opaque > 0.0
        f = f + torch.where(use_op[..., None], f_op * opaque[..., None], 0.0)
        pdf = pdf + torch.where(use_op, pdf_op * opaque, 0.0)
        return (torch.where(valid[..., None], f, 0.0),
                torch.where(valid, pdf, 0.0))

    def sample(self, wo, r4, emissive):
        a, m = self.alpha, self.metal
        sel_metal = r4[..., 3] < (0.0 + (1.0 - 0.0) * m)
        u2, rz = r4[..., :2], r4[..., 2]
        wm = _sample_vndf(a, wo, u2)
        dwm = _dot(wo, wm)
        wi_m = _reflect(-wo, wm)
        bad_m = wo[..., 2] * wi_m[..., 2] < 0.0
        f_m = _schlick(self.albedo, torch.abs(dwm)) * \
            _single_scatter(a, wo, wi_m, wm)[..., None] + self._multiscatter(
                wo[..., 2], wi_m[..., 2], (20.0 * self.albedo + 1.0) / 21.0)
        f_m = torch.where(bad_m[..., None], 0.0, f_m)
        pdf_m = torch.where(bad_m, 0.0, _ggx_pdf(a, wo, wm))
        glossy = torch.full(m.shape, SAMPLE_REFLECTED | SAMPLE_GLOSSY,
                            dtype=torch.int32, device=m.device)

        f_avg = self._f_avg()
        bf = self._pick_dielectric(wo[..., 2], f_avg)
        pick_d = rz < bf
        wi_d = _reflect(-wo, wm)
        bad_d = torch.sum(wm * wm, dim=-1) < 1e-12
        f_d = _fresnel(torch.abs(dwm), self.ior) * _single_scatter(
            a, wo, wi_d, wm) + self._multiscatter(wo[..., 2], wi_d[..., 2],
                                                  f_avg)
        f_d = torch.where(bad_d, 0.0, f_d)[..., None] * torch.ones_like(
            self.albedo)
        pdf_d = torch.where(bad_d, 0.0, _ggx_pdf(a, wo, wm) * bf)

        phi = u2[..., 0] * 2.0 * np.pi
        sin_t = torch.sqrt(u2[..., 1])
        cos_t = torch.sqrt(torch.clamp(1.0 - u2[..., 1], min=0.0))
        wi_c = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                            cos_t], -1)
        wi_c = wi_c * _flip(wo[..., 2:3] < 0.0, wi_c)
        f_c = self.albedo * self._diffuse(wo[..., 2], wi_c[..., 2])[..., None]
        pdf_c = torch.abs(wi_c[..., 2]) / np.pi * (1.0 - bf)
        flags_c = (SAMPLE_REFLECTED | SAMPLE_DIFFUSE) | torch.where(
            emissive, SAMPLE_EMITTED, 0).to(torch.int32)

        wi = torch.where(pick_d[..., None], wi_d, wi_c)
        f = torch.where(pick_d[..., None], f_d, f_c)
        pdf = torch.where(pick_d, pdf_d, pdf_c)
        flags = torch.where(pick_d, glossy, flags_c)
        wi = torch.where(sel_metal[..., None], wi_m, wi)
        f = torch.where(sel_metal[..., None], f_m, f)
        pdf = torch.where(sel_metal, pdf_m, pdf)
        flags = torch.where(sel_metal, glossy, flags)
        dead = pdf <= 0.0
        flags = torch.where(dead, 0, flags).to(torch.int32)
        f = torch.where(dead[..., None], 0.0, f)
        # the mixture pdf: a glossy or diffuse sample carries the whole
        # BSDF's value and density in that direction
        ev_f, ev_pdf = self.evaluate(wo, wi)
        keep = (dead | ((flags & SAMPLE_SPECULAR) != 0)
                | (wo[..., 2] * wi[..., 2] <= 0.0) | (ev_pdf <= 0.0))
        return (wi, torch.where(keep[..., None], f, ev_f),
                torch.where(keep, pdf, ev_pdf), flags)


# ---------------------------------------------------------------------------
# Tracing: instance bounding boxes, then every triangle of each box hit
# ---------------------------------------------------------------------------

class Tracer:
    SMALL = 64          # instances up to this many triangles are gathered
    PAIR_BUDGET = 1 << 22

    def __init__(self, tables):
        t = tables
        self.v0, self.e1, self.e2 = t["v0"], t["e1"], t["e2"]
        self.start, self.count = t["inst_start"], t["inst_count"]
        self.lo, self.hi = t["inst_lo"], t["inst_hi"]
        self.small = self.count <= self.SMALL
        self.n_small = int(self.count[self.small].max()) if bool(
            self.small.any()) else 0
        self.big = [int(i) for i in torch.nonzero(~self.small)[:, 0]]

    def _mt(self, o, d, v0, e1, e2, tmin, tmax):
        pvec = _cross(d, e2)
        det = _dot(e1, pvec)
        inv = 1.0 / det
        tvec = o - v0
        u = _dot(tvec, pvec) * inv
        qvec = _cross(tvec, e1)
        v = _dot(d, qvec) * inv
        t = _dot(e2, qvec) * inv
        ok = ((det != 0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > tmin) & (t < tmax))
        return torch.where(ok, t, float("inf"))

    def _boxes(self, o, d, tmin, tmax):
        d_safe = torch.where(torch.abs(d) < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)
        inv = 1.0 / d_safe
        rays, insts = [], []
        step = max(1, self.PAIR_BUDGET // max(1, len(self.lo)))
        for a in range(0, o.shape[0], step):
            oo, ii = o[a:a + step, None, :], inv[a:a + step, None, :]
            t1, t2 = (self.lo[None] - oo) * ii, (self.hi[None] - oo) * ii
            tn = torch.amax(torch.minimum(t1, t2), -1)
            tf = torch.amin(torch.maximum(t1, t2), -1)
            hit = (tn <= tf) & (tf >= tmin) & (tn <= tmax[a:a + step, None])
            r, i = torch.nonzero(hit, as_tuple=True)
            rays.append(r + a)
            insts.append(i)
        return torch.cat(rays), torch.cat(insts)

    def closest(self, o, d, tmin, tmax):
        """(t, tri, u, v, hit) of each ray's closest hit in (tmin, tmax)."""
        n = o.shape[0]
        dev = o.device
        best = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
        best_tri = torch.full((n,), -1, dtype=torch.long, device=dev)
        if n == 0:
            return best, best_tri, best, best, best_tri >= 0
        pr, pi = self._boxes(o, d, tmin, tmax)
        cand_r, cand_t, cand_tri = [], [], []
        sm = self.small[pi]
        if self.n_small and bool(sm.any()):
            r, i = pr[sm], pi[sm]
            k = torch.arange(self.n_small, device=dev)
            step = max(1, self.PAIR_BUDGET // self.n_small)
            for a in range(0, r.shape[0], step):
                rr, ii = r[a:a + step], i[a:a + step]
                tri = self.start[ii][:, None] + k[None]
                valid = k[None] < self.count[ii][:, None]
                tri = torch.where(valid, tri, self.start[ii][:, None])
                t = self._mt(o[rr][:, None], d[rr][:, None], self.v0[tri],
                             self.e1[tri], self.e2[tri], tmin,
                             tmax[rr][:, None])
                t = torch.where(valid, t, float("inf"))
                tb, kb = torch.min(t, 1)
                cand_r.append(rr)
                cand_t.append(tb)
                cand_tri.append(torch.gather(tri, 1, kb[:, None])[:, 0])
        for inst in self.big:
            rr = pr[pi == inst]
            if rr.numel() == 0:
                continue
            s, c = int(self.start[inst]), int(self.count[inst])
            v0, e1, e2 = (x[s:s + c][None] for x in (self.v0, self.e1,
                                                     self.e2))
            step = max(1, self.PAIR_BUDGET // c)
            for a in range(0, rr.shape[0], step):
                r = rr[a:a + step]
                t = self._mt(o[r][:, None], d[r][:, None], v0, e1, e2, tmin,
                             tmax[r][:, None])
                tb, kb = torch.min(t, 1)
                cand_r.append(r)
                cand_t.append(tb)
                cand_tri.append(kb + s)
        if cand_r:
            r, t, tri = torch.cat(cand_r), torch.cat(cand_t), \
                torch.cat(cand_tri)
            best.scatter_reduce_(0, r, t, "amin")
            win = (t == best[r]) & torch.isfinite(t)
            best_tri.scatter_reduce_(0, r[win], tri[win], "amax")
        hit = best_tri >= 0
        tri = torch.clamp(best_tri, min=0)
        e1, e2, v0 = self.e1[tri], self.e2[tri], self.v0[tri]
        pvec = _cross(d, e2)
        inv = 1.0 / _dot(e1, pvec)
        tvec = o - v0
        u = _dot(tvec, pvec) * inv
        v = _dot(d, _cross(tvec, e1)) * inv
        return best, tri, u, v, hit


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def device_tables(scene: dict, lights: np.ndarray, total_power, device,
                  dtype) -> dict:
    """The compiled scene as tensors: floats in `dtype`, indices int64."""
    out = {}
    for k, v in scene.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            out[k] = t.to(dtype) if t.is_floating_point() else (
                t if t.dtype == torch.bool else t.long())
        else:
            out[k] = v
    out["lights"] = torch.from_numpy(lights).to(device=device, dtype=dtype)
    out["light_alias"] = torch.from_numpy(lights[:, 15].astype(np.int64)).to(
        device)
    out["total_power"] = torch.tensor(float(total_power), dtype=dtype,
                                      device=device)
    return out


def _interpolate(t, tri, u, v, o, d, hit):
    tri = torch.where(hit, tri, 0)
    w = 1.0 - u - v
    nn = t["normals"][tri]
    normal = _normalize(nn[:, 0:3] * w[:, None] + nn[:, 3:6] * u[:, None]
                        + nn[:, 6:9] * v[:, None])
    tan4 = t["tangents"][tri]
    tangent = _normalize(tan4[:, :3])
    gnormal = _normalize(_cross(t["e1"][tri], t["e2"][tri]))
    return normal, tangent, tan4[:, 3], gnormal, t["tri_mat"][tri]


def _frame(n, tg, sign):
    a = torch.where((torch.abs(n[..., 0]) > 0.5)[..., None],
                    _const([0.0, 0.0, 1.0], n), _const([1.0, 0.0, 0.0], n))
    fb = _normalize(_cross(n, a))
    ft = _cross(n, fb)
    bad = torch.abs(_dot(n, tg)) > 0.9
    b = _normalize(_cross(n, tg)) * sign[..., None]
    t2 = _cross(b, n)
    return (torch.where(bad[..., None], ft, t2),
            torch.where(bad[..., None], fb, b), n)


def _sample_light(t, pos, u_sel, u2):
    rows = t["lights"]
    n = rows.shape[0]
    if n == 0:                          # no emitter: nothing to sample
        z = torch.zeros_like(pos)
        return z, z, z[:, 0], z[:, 0], z[:, 0]
    scaled = u_sel * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    frac = torch.clamp(scaled - slot.to(scaled.dtype), 0.0, 1.0)
    idx = torch.where(frac >= rows[slot, 14], t["light_alias"][slot], slot)
    row = rows[idx]
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    ux, uy = u2[..., 0], u2[..., 1]
    lt = ux < uy
    b0 = torch.where(lt, ux * 0.5, ux - uy * 0.5)
    b1 = torch.where(lt, uy - ux * 0.5, uy * 0.5)
    lpos = v0 + e1 * b0[:, None] + e2 * b1[:, None]
    nrm = _normalize(_cross(e1, e2))
    delta = lpos - pos
    dist2 = torch.sum(delta * delta, -1)
    dist = torch.sqrt(dist2)
    wi = delta / torch.clamp(dist[:, None], min=1e-20)
    pdf = dist2 / torch.clamp(torch.abs(_dot(nrm, wi)) * row[:, 12],
                              min=1e-20)
    return row[:, 9:12], wi, dist, pdf, row[:, 13]


def render_lanes(t: dict, tracer: Tracer, px, py, sample, max_bounces: int,
                 dtype):
    """(R, 3) radiance of one sample of each lane (pixel px, py; sample
    index `sample`), float32 out; every lane runs alone."""
    dev = px.device
    n = px.shape[0]
    st = Halton(px, py, sample)
    jit = st.next(2).to(dtype)
    st.next(2)                          # the lens draw (no aperture here)
    fx = px.to(dtype) + jit[:, 0]
    fy = py.to(dtype) + jit[:, 1]
    film = (t["cam_top_left"] + fx[:, None] * t["cam_du"]
            + fy[:, None] * t["cam_dv"])
    o = t["cam_pos"].expand(n, 3).clone()
    d = _normalize(film - o)
    L = torch.zeros((n, 3), dtype=dtype, device=dev)
    atten = torch.ones((n, 3), dtype=dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, dtype=dtype, device=dev)
    prev_spec = torch.ones(n, dtype=torch.bool, device=dev)
    inf = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    for bounce in range(max_bounces):
        if not bool(active.any()):
            break
        idx = torch.nonzero(active)[:, 0]
        t_all = inf.clone()
        tri_all = torch.zeros(n, dtype=torch.long, device=dev)
        u_all = torch.zeros(n, dtype=dtype, device=dev)
        v_all = torch.zeros(n, dtype=dtype, device=dev)
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        th, trh, uh, vh, hh = tracer.closest(o[idx], d[idx], RAY_EPS, inf[idx])
        t_all[idx], tri_all[idx], u_all[idx], v_all[idx], hit[idx] = \
            th, trh, uh, vh, hh
        hit = hit & active
        normal, tangent, sign, gnormal, mat = _interpolate(
            t, tri_all, u_all, v_all, o, d, hit)
        tt = torch.where(hit, t_all, 0.0)
        if dtype == torch.float32:
            pos = (o.double() + d.double() * tt.double()[:, None]).float()
        else:
            pos = o + d * tt[:, None]
        ft, fb, fn = _frame(normal, tangent, sign)
        wo = torch.stack([_dot(-d, ft), _dot(-d, fb), _dot(-d, fn)], -1)
        bs = Bsdf(t, mat)
        emissive = t["emissive"][mat]

        le = bs.emitted(t)
        cos_hit = torch.abs(_dot(d, gnormal))
        dist2 = torch.sum((pos - o) ** 2, -1)
        light_pdf = ((1.0 - 0.0) * (t["emission"][mat][:, 1] * np.pi
                                    / torch.clamp(t["total_power"], min=1e-20))
                     * dist2 / torch.clamp(cos_hit, min=1e-20))
        w_emit = torch.where(prev_spec, 1.0, prev_pdf / torch.clamp(
            prev_pdf + light_pdf, min=1e-20))
        L = L + torch.where(hit[:, None], atten * le * w_emit[:, None], 0.0)

        r2 = st.next(2)
        r3 = st.next()
        r4 = st.next()
        st.next(2)                      # the coat's draw (no clearcoat here)
        r4 = torch.cat([r2, r3[:, None], r4[:, None]], -1).to(dtype)
        s_wi, s_f, s_pdf, s_flags = bs.sample(wo, r4, emissive)

        u_nee = st.next(2).to(dtype)
        u_sel = st.next().to(dtype)
        li, wi_w, ldist, lpdf, p_light = _sample_light(t, pos, u_sel, u_nee)
        wi_l = torch.stack([_dot(wi_w, ft), _dot(wi_w, fb), _dot(wi_w, fn)],
                           -1)
        ev_f, ev_pdf = bs.evaluate(wo, wi_l)
        do_nee = hit & bs.wants_nee() & (torch.sum(ev_f * ev_f, -1) > 0.0)
        ld = li * ev_f * torch.abs(wi_l[:, 2:3]) / torch.clamp(
            p_light * lpdf + ev_pdf, min=1e-20)[:, None]
        sh_ld = torch.where(do_nee[:, None], atten * ld, 0.0)
        sh_max = torch.where(do_nee, ldist, 0.0) - RAY_EPS

        cont = (s_flags & (SAMPLE_REFLECTED | SAMPLE_TRANSMITTED)) != 0
        atten_new = atten * s_f * torch.abs(s_wi[:, 2:3]) / torch.clamp(
            s_pdf, min=1e-20)[:, None]
        u_rr = st.next().to(dtype)
        q = torch.clamp(1.0 - torch.amax(atten_new, -1), min=0.0)
        if bounce == 0:
            q = torch.zeros_like(q)
        atten_new = atten_new / torch.clamp(1.0 - q, min=1e-20)[:, None]
        active_new = hit & cont & (s_pdf > 0.0) & ~(u_rr < q)
        wi_next = _normalize(ft * s_wi[:, 0:1] + fb * s_wi[:, 1:2]
                             + fn * s_wi[:, 2:3])
        o = torch.where(hit[:, None], pos, o)
        d = torch.where(hit[:, None], wi_next, d)
        atten = torch.where(active_new[:, None], atten_new, atten)
        active = active_new
        prev_pdf = torch.where(hit, s_pdf, prev_pdf)
        prev_spec = torch.where(hit, (s_flags & (SAMPLE_SPECULAR
                                                 | SAMPLE_TRANSMITTED)) != 0,
                                prev_spec)

        sidx = torch.nonzero(do_nee)[:, 0]
        if sidx.numel():
            s_t, _, _, _, s_hit = tracer.closest(pos[sidx], wi_w[sidx],
                                                 RAY_EPS, sh_max[sidx])
            clear = torch.zeros(n, dtype=torch.bool, device=dev)
            clear[sidx] = ~s_hit
            L = L + torch.where(clear[:, None], sh_ld, 0.0)
    return L.float()


def render_pixels(t: dict, pixels: np.ndarray, samples, max_bounces: int,
                  dtype=torch.float32, lanes_per_call: int = 1 << 16):
    """(P, S, 3) float32 radiance of every pixel in `pixels` (flat ids)
    at every sample index in `samples`."""
    dev = t["v0"].device
    tracer = Tracer(t)
    w = t["width"]
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.long, device=dev)
    smp = torch.as_tensor(np.asarray(samples), dtype=torch.long, device=dev)
    lane_pix = pix.repeat_interleave(len(smp))
    lane_smp = smp.repeat(len(pix))
    out = torch.empty((lane_pix.shape[0], 3), dtype=torch.float32,
                      device=dev)
    for a in range(0, lane_pix.shape[0], lanes_per_call):
        p = lane_pix[a:a + lanes_per_call]
        out[a:a + lanes_per_call] = render_lanes(
            t, tracer, p % w, p // w, lane_smp[a:a + lanes_per_call],
            max_bounces, dtype)
    return out.reshape(len(pix), len(smp), 3)


def scene_lights(scene: dict, light_rows, dtype):
    """(light table rows, total power, light_rows gap) over the program's
    emissive-triangle order, `light_rows` (L, >= 9; v0 e1 e2), with the
    widest corner gap to the scene's (match_lights); `light_rows` None
    takes the reference's own order, and the gap is then that of the rows
    as held in `dtype` to the exact ones (0 in float32)."""
    if light_rows is not None:
        order, gap = match_lights(scene, light_rows)
        return (*light_table(scene, order), gap)
    rows, total = light_table(scene, scene["light_tris"])
    held = torch.from_numpy(rows[:, :9]).to(dtype).float().numpy()
    gap = float(np.abs(held - rows[:, :9]).max()) if len(rows) else 0.0
    return rows, total, gap


def radiance(arrays: dict, width: int, height: int, max_bounces: int,
             pixels, samples, light_rows, device, dtype=torch.float32):
    """((P, S, 3) float32 radiance of `pixels` (flat ids) at every sample
    index in `samples`, light_rows gap as scene_lights gives it)."""
    scene = compile_scene(arrays, width, height)
    rows, total, gap = scene_lights(scene, light_rows, dtype)
    tables = device_tables(scene, rows, total, device, dtype)
    return render_pixels(tables, pixels, samples, max_bounces, dtype), gap
