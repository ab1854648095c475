"""The plain reference of `helmet_env`: a textured, normal-mapped,
self-emitting metal-rough asset under an HDR sky, path traced with the
program's documented estimator, written from glTF 2.0 and from the
program's documentation in plain PyTorch and NumPy.

It imports nothing of the program. It reuses
portbench/reference/pathtracer.py's parts (the Halton sampler, the GGX
and Fresnel terms, the BSDF's lobe structure, the box-culled tracer,
Vose's alias table) and the test cell's sky functions
(portbench/testcell/reference/direct_light.py: the sky's pixels and alias
table worked out from the scene's arrays, its bilinear lookup, its draw),
and adds what neither covers:
- textures: bilinear, repeat-wrapped taps of the u8 maps, each tap decoded
  (sRGB or linear) before the blend; base colour replaces the factor,
  roughness, metal and emission multiply theirs (glTF);
- the normal map: the tangent-space normal taken to the shading frame of
  the interpolated normal and the first vertex's tangent and handedness,
  and a new frame built from the mapped normal alone;
- the GGX energy terms per lane, from the frozen LUTs (ggx_energy.npz) at
  the lane's textured roughness;
- the sky: escaped rays weighted by MIS against the sky's pdf, NEE split
  between the sky and the area lights by p_infinite (1/2 with both);
- area NEE whose radiance is the emission factor times the emission texel
  at the sampled point (glTF's emitted radiance), the light picked by the
  factor's power, and the MIS weight of a BSDF hit on an emitter from the
  same factor power;
- a tracer over clusters of 64 triangles sorted along a Morton curve.
The bounce loop, Russian roulette and the sampler's dimensions are the
program's, to `max_bounces` bounces.

Departures from glTF, each the program's documented estimator:
- emission seen on a hit is scaled by the probability of the opaque,
  non-metal lobe, (1 - metal), as the Metal reference does; NEE's
  emitted radiance is not;
- the occlusion map is not used (the configuration leaves it out; a path
  tracer computes occlusion);
- the base-colour texture replaces the factor where glTF multiplies (the
  same at factor 1, the asset's);
- the diffuse lobe is energy-compensated under the dielectric coat, and
  the metal lobe has Kulla-Conty multiscatter, both from the LUTs;
- u8 taps are filtered after decoding, as an sRGB sampler does;
- roughness below sqrt(1e-3) (the program's smooth lobes) is refused.

One thing is taken from the program and checked: the order of its light
rows (`match_lights`). `estimator="untextured_nee"` is the control of the
textured emitters: the program's estimator before NEE read the emission
texel (NEE emits the factor alone, and a BSDF hit's MIS weight takes the
textured emission), which must come out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import pathtracer as pt
from portbench.testcell.reference import direct_light as dl

CLUSTER = 64
SMOOTH_ALPHA = 1e-3
SLOTS = ("base_color", "roughness_metallic", "emission", "normal")


# ---------------------------------------------------------------------------
# Scene compile (numpy)
# ---------------------------------------------------------------------------

def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points (N, 3) in their bounding box."""
    lo, hi = c.min(0), c.max(0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for b in range(10):
        for k in range(3):
            code |= ((q[:, k] >> b) & 1) << (3 * b + k)
    return code


def _u8_rgba(tex: dict) -> np.ndarray:
    """A u8 map widened to RGBA as the program's atlas stores it: one
    channel repeated to RGB, two channels (roughness, metal) then 0,
    alpha 255 where absent."""
    d = np.asarray(tex["data"])
    if d.dtype != np.uint8:
        raise ValueError("the reference takes u8 material maps")
    if d.ndim == 2:
        d = d[:, :, None]
    h, w, c = d.shape
    if c == 1:
        d = np.repeat(d, 3, axis=2)
    elif c == 2:
        d = np.concatenate([d, np.zeros((h, w, 1), np.uint8)], axis=2)
    if d.shape[2] < 4:
        d = np.concatenate([d, np.full((h, w, 4 - d.shape[2]), 255,
                                       np.uint8)], axis=2)
    return np.ascontiguousarray(d[:, :, :4])


def compile_scene(arrays: dict, width: int, height: int) -> dict:
    """pathtracer.compile_scene's tables of the scene without its maps
    and sky (world triangles, material factors, camera), with each
    triangle's uvs and each material's maps added, the triangles in
    cluster order, and the emissive triangles as the program counts them
    (a factor or an emission texture, and a strength)."""
    names = list(arrays["materials"])
    mats = [dict(pt.MATERIAL_DEFAULTS, **arrays["materials"][k]) for k in names]
    for m in mats:
        if m["transmission"] or m["anisotropy"] or m["clearcoat"] or (
                set(m.get("textures", {})) - set(SLOTS)):
            raise ValueError("the reference covers opaque metal-rough "
                             "materials with the glTF core maps only")
    tex_names = sorted({t for m in mats for t in m.get("textures", {}).values()})
    maps = [_u8_rgba(arrays["textures"][t]) for t in tex_names]
    slot_tex = np.full((len(mats), len(SLOTS)), -1, np.int64)
    for k, m in enumerate(mats):
        for s, t in m.get("textures", {}).items():
            slot_tex[k, SLOTS.index(s)] = tex_names.index(t)
        rm = slot_tex[k, SLOTS.index("roughness_metallic")]
        r_min = (maps[rm][..., 0].min() / 255.0 if rm >= 0 else 1.0) \
            * m["roughness"]
        if r_min ** 2 < SMOOTH_ALPHA:
            raise ValueError("the reference has no smooth lobes")
    bare = {k: v for k, v in arrays.items()
            if k not in ("textures", "environment")}
    bare["materials"] = {k: {kk: v for kk, v in m.items() if kk != "textures"}
                         for k, m in arrays["materials"].items()}
    scene = pt.compile_scene(bare, width, height)

    uvs = np.concatenate([np.concatenate(
        [arrays["meshes"][mesh]["uvs"][
            arrays["meshes"][mesh]["indices"][:, k].astype(np.int64)]
         for k in range(3)], -1) for _n, mesh, *_ in arrays["instances"]])
    v0, e1, e2 = scene["v0"], scene["e1"], scene["e2"]
    order = np.argsort(_morton(v0 + (e1 + e2) / 3.0), kind="stable")
    scene.update({k: scene[k][order] for k in ("v0", "e1", "e2", "normals",
                                               "tangents", "tri_mat")})
    v0, e1, e2 = scene["v0"], scene["e1"], scene["e2"]
    starts = np.arange(0, len(v0), CLUSTER)
    counts = np.minimum(CLUSTER, len(v0) - starts)
    corners = np.stack([v0, v0 + e1, v0 + e2], 1)
    lo = np.stack([corners[a:a + c].reshape(-1, 3).min(0)
                   for a, c in zip(starts, counts)])
    hi = np.stack([corners[a:a + c].reshape(-1, 3).max(0)
                   for a, c in zip(starts, counts)])
    pad = 1e-4 * (np.abs(lo) + np.abs(hi)) + 1e-4
    emissive = np.array([(max(m["emission"]) > 0 or "emission" in
                          m.get("textures", {})) and m["emission_strength"] > 0
                         for m in mats])
    scene.update(
        uvs=uvs.astype(np.float32)[order], inst_start=starts,
        inst_count=counts, inst_lo=(lo - pad).astype(np.float32),
        inst_hi=(hi + pad).astype(np.float32), emissive=emissive,
        light_tris=np.nonzero(emissive[scene["tri_mat"]])[0],
        slot_tex=slot_tex, maps=maps,
        srgb=[arrays["textures"][t]["format"] == "srgb_rgba"
              for t in tex_names])
    return scene


def match_lights(scene: dict, program_rows: np.ndarray):
    """pathtracer.match_lights without its (L, L) table: rows equal bit
    for bit are matched by value, the rest by the nearest corners in
    chunks. Returns (triangle ids in the program's order, widest gap)."""
    lt = scene["light_tris"]
    ours = np.concatenate([scene["v0"][lt], scene["e1"][lt], scene["e2"][lt]],
                          -1).astype(np.float32)
    theirs = np.asarray(program_rows, np.float32)[:, :9]
    if theirs.shape[0] != len(lt):
        raise ValueError(f"the program has {theirs.shape[0]} emissive "
                         f"triangles, the reference {len(lt)}")
    if len(lt) == 0:
        return lt, 0.0
    by_value = {r.tobytes(): i for i, r in enumerate(ours)}
    pick = np.array([by_value.get(r.tobytes(), -1) for r in theirs])
    rest = np.nonzero(pick < 0)[0]
    o64 = ours.astype(np.float64)
    for a in range(0, len(rest), 256):
        rows = rest[a:a + 256]
        gap = np.abs(theirs[rows, None, :].astype(np.float64)
                     - o64[None]).max(-1)
        pick[rows] = gap.argmin(1)
    if len(np.unique(pick)) != len(lt):
        raise ValueError("the program's light rows are not a permutation of "
                         "the scene's emissive triangles")
    gap = float(np.abs(theirs.astype(np.float64) - o64[pick]).max())
    return lt[pick], gap


def scene_lights(scene: dict, light_rows, dtype):
    """pathtracer.scene_lights over this module's match_lights."""
    if light_rows is not None:
        order, gap = match_lights(scene, light_rows)
        return (order, *pt.light_table(scene, order), gap)
    order = scene["light_tris"]
    rows, total = pt.light_table(scene, order)
    held = torch.from_numpy(rows[:, :9]).to(dtype).float().numpy()
    gap = float(np.abs(held - rows[:, :9]).max()) if len(rows) else 0.0
    return order, rows, total, gap


# ---------------------------------------------------------------------------
# Lookups: maps, LUTs
# ---------------------------------------------------------------------------

def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def tap(img: torch.Tensor, srgb: bool, uv: torch.Tensor, dtype):
    """(R, 4) linear bilinear sample of a u8 RGBA map (H, W, 4) at uv,
    repeat-wrapped, each texel decoded before the blend."""
    h, w = img.shape[0], img.shape[1]
    u = uv[:, 0] * float(w) - 0.5
    v = uv[:, 1] * float(h) - 0.5
    uf, vf = torch.floor(u), torch.floor(v)
    fu, fv = (u - uf)[:, None], (v - vf)[:, None]

    def texel(ui, vi):
        # the integer wrap again: a bfloat16 remainder can round up to w
        xi = torch.remainder(ui, float(w)).to(torch.int32).long() % w
        yi = torch.remainder(vi, float(h)).to(torch.int32).long() % h
        f = img[yi, xi].to(torch.float32) * (1.0 / 255.0)
        if srgb:
            f = torch.cat([_srgb_to_linear(f[:, :3]), f[:, 3:4]], -1)
        return f.to(dtype)

    c00, c10 = texel(uf, vf), texel(uf + 1, vf)
    c01, c11 = texel(uf, vf + 1), texel(uf + 1, vf + 1)
    return ((c00 * (1 - fu) + c10 * fu) * (1 - fv)
            + (c01 * (1 - fu) + c11 * fu) * fv)


def _axis(coord, n):
    x = torch.clamp(coord * n - 0.5, 0.0, n - 1.0)
    x0 = torch.floor(x)
    i0 = x0.long().clamp(0, n - 1)      # NaN-safe
    return i0, torch.clamp(i0 + 1, max=n - 1), x - x0


def lut1(lut, u):
    i0, i1, f = _axis(u, lut.shape[0])
    return lut[i0] * (1 - f) + lut[i1] * f


def lut2(lut, u, v):
    """lut (H, W) indexed [v, u], clamp-to-edge, texel-centred."""
    h, w = lut.shape
    x0, x1, fx = _axis(u, w)
    y0, y1, fy = _axis(v, h)
    return ((lut[y0, x0] * (1 - fx) + lut[y0, x1] * fx) * (1 - fy)
            + (lut[y1, x0] * (1 - fx) + lut[y1, x1] * fx) * fy)


def lut3(lut, u, v, w_):
    d, h, w = lut.shape
    x0, x1, fx = _axis(u, w)
    y0, y1, fy = _axis(v, h)
    z0, z1, fz = _axis(w_, d)

    def bil(z):
        return ((lut[z, y0, x0] * (1 - fx) + lut[z, y0, x1] * fx) * (1 - fy)
                + (lut[z, y1, x0] * (1 - fx) + lut[z, y1, x1] * fx) * fy)

    return bil(z0) * (1 - fz) + bil(z1) * fz


class TexturedBsdf(pt.Bsdf):
    """pathtracer.Bsdf's lobes with per-lane parameters (textured albedo,
    roughness, metal, emission) and its energy terms from the LUTs at
    the lane's roughness."""

    def __init__(self, luts, albedo, rough, metal, ior, emission, emissive):
        self.luts = luts
        self.albedo, self.rough, self.metal, self.ior = albedo, rough, metal, ior
        self.alpha = rough * rough
        self.em, self.is_emissive = emission, emissive
        self.iorp = (ior - 1.0) / torch.clamp(ior, min=1e-6)

    def _multiscatter(self, wo_z, wi_z, f_avg):
        s = pt._flip(wo_z < 0.0, wo_z)
        wo_z, wi_z = wo_z * s, wi_z * s
        e = self.luts["E"]
        e_wo, e_wi = lut2(e, wo_z, self.rough), lut2(e, wi_z, self.rough)
        e_avg = lut1(self.luts["E_avg"], self.rough)
        ms = (1.0 - e_wo) * (1.0 - e_wi) / (
            np.pi * torch.clamp(1.0 - e_avg, min=1e-5))
        if f_avg.dim() == 2:
            e_avg, ms = e_avg[:, None], ms[:, None]
        return f_avg * f_avg * e_avg / torch.clamp(
            1.0 - f_avg * (1.0 - e_avg), min=1e-5) * ms

    def _diffuse(self, wo_z, wi_z):
        s = pt._flip(wo_z < 0.0, wo_z)
        wo_z, wi_z = wo_z * s, wi_z * s
        e = self.luts["E_ms"]
        e_wo = lut3(e, wo_z, self.rough, self.iorp)
        e_wi = lut3(e, wi_z, self.rough, self.iorp)
        e_avg = lut2(self.luts["E_ms_avg"], self.iorp, self.rough)
        return (1.0 - e_wo) * (1.0 - e_wi) / (
            np.pi * torch.clamp(1.0 - e_avg, min=1e-5))

    def _pick_dielectric(self, wo_z, f_avg):
        c = torch.abs(wo_z)
        e_wo = lut2(self.luts["E"], c, self.rough)
        e_ms = lut3(self.luts["E_ms"], c, self.rough, self.iorp)
        fms = f_avg * f_avg * e_wo / torch.clamp(
            1.0 - f_avg * (1.0 - e_wo), min=1e-5)
        return torch.clamp(f_avg * e_ms + fms * (1.0 - e_ms), 0.0, 0.999)

    def emitted(self, tables=None):
        p_opaque = (1.0 - 0.0) * (1.0 - self.metal) * (1.0 - 0.0)
        return torch.where(self.is_emissive[:, None],
                           self.em * p_opaque[:, None], 0.0)


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def device_tables(scene, order, rows, total, device, dtype) -> dict:
    t = pt.device_tables({k: v for k, v in scene.items()
                          if k not in ("maps", "srgb")},
                         rows, total, device, dtype)
    t["maps"] = [torch.from_numpy(m).to(device) for m in scene["maps"]]
    t["srgb"] = scene["srgb"]
    luv = scene["uvs"][order] if len(order) else np.zeros((0, 6), np.float32)
    t["light_uv"] = torch.from_numpy(np.ascontiguousarray(luv)).to(
        device=device, dtype=dtype)
    t["light_mat"] = torch.from_numpy(scene["tri_mat"][order]).to(device)
    lut = np.load(pt.ENERGY_FILE)
    t["luts"] = {k: torch.from_numpy(lut[k]).to(device=device, dtype=dtype)
                 for k in ("E", "E_avg", "E_ms", "E_ms_avg")}
    return t


def _slot(t, mat, k, uv, dtype):
    """(has (R,), linear RGBA (R, 4)) of material slot k at uv."""
    tid = t["slot_tex"][mat, k]
    has = tid >= 0
    out = torch.zeros((uv.shape[0], 4), dtype=dtype, device=uv.device)
    for i, img in enumerate(t["maps"]):
        sel = tid == i
        if bool(sel.any()):
            out[sel] = tap(img, t["srgb"][i], uv[sel], dtype)
    return has, out


def _sample_area(t, pos, u_sel, u2, dtype, texel: bool):
    """pathtracer._sample_light, its radiance times the emission texel at
    the sampled point where `texel`."""
    li, wi, dist, pdf, p_light = pt._sample_light(t, pos, u_sel, u2)
    rows = t["lights"]
    n = rows.shape[0]
    if n == 0 or not texel:
        return li, wi, dist, pdf, p_light
    scaled = u_sel * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    frac = torch.clamp(scaled - slot.to(scaled.dtype), 0.0, 1.0)
    idx = torch.where(frac >= rows[slot, 14], t["light_alias"][slot], slot)
    ux, uy = u2[..., 0], u2[..., 1]
    lt = ux < uy
    b0 = torch.where(lt, ux * 0.5, ux - uy * 0.5)[:, None]
    b1 = torch.where(lt, uy - ux * 0.5, uy * 0.5)[:, None]
    luv = t["light_uv"][idx]
    w = 1.0 - b0 - b1
    uv = luv[:, 0:2] * w + luv[:, 2:4] * b0 + luv[:, 4:6] * b1
    has, em = _slot(t, t["light_mat"][idx], SLOTS.index("emission"), uv,
                    dtype)
    return li * torch.where(has[:, None], em[:, :3], 1.0), wi, dist, pdf, \
        p_light


def _env_pdf(env, d):
    """The sky's solid-angle pdf of direction d (its texel's)."""
    h, w = env["pixels"].shape[:2]
    uv = dl._env_uv(d)
    # truncated, then clamped: the same texel as clamping first, and in
    # bfloat16 (where h - 1 may round up to h) still inside the map
    x = torch.clamp((torch.remainder(uv[..., 0], 1.0) * w).long(), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).long(), 0, h - 1)
    sin_t = torch.sqrt(torch.clamp(1.0 - d[..., 1] * d[..., 1], min=0.0))
    return env["pdf"][y * w + x] / (2.0 * np.pi * np.pi
                                    * torch.clamp(sin_t, min=1e-4))


def render_lanes(t, env, tracer, px, py, sample, max_bounces, dtype,
                 nee_texel: bool = True):
    """(R, 3) radiance of one sample of each lane, the program's bounce
    loop lane by lane."""
    dev = px.device
    n = px.shape[0]
    st = pt.Halton(px, py, sample)
    jit = st.next(2).to(dtype)
    st.next(2)                          # the lens draw (no aperture here)
    film = (t["cam_top_left"] + (px.to(dtype) + jit[:, 0])[:, None]
            * t["cam_du"] + (py.to(dtype) + jit[:, 1])[:, None] * t["cam_dv"])
    o = t["cam_pos"].expand(n, 3).clone()
    d = pt._normalize(film - o)
    L = torch.zeros((n, 3), dtype=dtype, device=dev)
    atten = torch.ones((n, 3), dtype=dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, dtype=dtype, device=dev)
    prev_spec = torch.ones(n, dtype=torch.bool, device=dev)
    inf = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    n_lights = t["lights"].shape[0]
    has_env = env is not None
    p_inf = torch.tensor(0.5 if (has_env and n_lights) else
                         (1.0 if has_env else 0.0), dtype=dtype, device=dev)
    for bounce in range(max_bounces):
        if not bool(active.any()):
            break
        idx = torch.nonzero(active)[:, 0]
        t_all = inf.clone()
        tri_all = torch.zeros(n, dtype=torch.long, device=dev)
        u_all = torch.zeros(n, dtype=dtype, device=dev)
        v_all = torch.zeros(n, dtype=dtype, device=dev)
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        th, trh, uh, vh, hh = tracer.closest(o[idx], d[idx], pt.RAY_EPS,
                                             inf[idx])
        t_all[idx], tri_all[idx], u_all[idx], v_all[idx], hit[idx] = \
            th, trh, uh, vh, hh
        miss = active & ~hit
        hit = hit & active
        if has_env:
            env_le = dl._env_radiance(env, d)
            w_env = torch.where(prev_spec, 1.0, prev_pdf / torch.clamp(
                prev_pdf + _env_pdf(env, d) * p_inf, min=1e-20))
            L = L + torch.where(miss[:, None], atten * env_le * w_env[:, None],
                                0.0)

        normal, tangent, sign, gnormal, mat = pt._interpolate(
            t, tri_all, u_all, v_all, o, d, hit)
        tri = torch.where(hit, tri_all, 0)
        tw = (1.0 - u_all - v_all)[:, None]
        tuv = t["uvs"][tri]
        uv = (tuv[:, 0:2] * tw + tuv[:, 2:4] * u_all[:, None]
              + tuv[:, 4:6] * v_all[:, None])
        tt = torch.where(hit, t_all, 0.0)
        if dtype == torch.float32:
            pos = (o.double() + d.double() * tt.double()[:, None]).float()
        else:
            pos = o + d * tt[:, None]
        ft, fb, fn = pt._frame(normal, tangent, sign)

        albedo, rough = t["albedo"][mat], t["rough"][mat]
        metal, emission = t["metal"][mat], t["emission"][mat]
        has, base = _slot(t, mat, 0, uv, dtype)
        albedo = torch.where(has[:, None], base[:, :3], albedo)
        has, rm = _slot(t, mat, 1, uv, dtype)
        rough = rough * torch.where(has, rm[:, 0], 1.0)
        metal = metal * torch.where(has, rm[:, 1], 1.0)
        has, em = _slot(t, mat, 2, uv, dtype)
        emission = emission * torch.where(has[:, None], em[:, :3], 1.0)
        has, nm = _slot(t, mat, 3, uv, dtype)
        nm = nm[:, :3] * 2.0 - 1.0
        mapped = pt._normalize(ft * nm[:, 0:1] + fb * nm[:, 1:2]
                               + fn * nm[:, 2:3])
        mt, mb, mn = dl._from_normal(mapped)
        sel = has[:, None]
        ft, fb, fn = (torch.where(sel, a, b) for a, b in ((mt, ft), (mb, fb),
                                                          (mn, fn)))
        wo = torch.stack([pt._dot(-d, ft), pt._dot(-d, fb), pt._dot(-d, fn)],
                         -1)
        emissive = t["emissive"][mat]
        bs = TexturedBsdf(t["luts"], albedo, rough, metal, t["ior"][mat],
                          emission, emissive)

        le = bs.emitted()
        cos_hit = torch.abs(pt._dot(d, gnormal))
        dist2 = torch.sum((pos - o) ** 2, -1)
        em_g = emission[:, 1] if not nee_texel else t["emission"][mat][:, 1]
        light_pdf = ((1.0 - p_inf) * (em_g * np.pi / torch.clamp(
            t["total_power"], min=1e-20)) * dist2
            / torch.clamp(cos_hit, min=1e-20))
        w_emit = torch.where(prev_spec | (n_lights == 0), 1.0,
                             prev_pdf / torch.clamp(prev_pdf + light_pdf,
                                                    min=1e-20))
        L = L + torch.where(hit[:, None], atten * le * w_emit[:, None], 0.0)

        r2 = st.next(2)
        r3 = st.next()
        r4 = st.next()
        st.next(2)                      # the coat's draw (no clearcoat here)
        r4 = torch.cat([r2, r3[:, None], r4[:, None]], -1).to(dtype)
        s_wi, s_f, s_pdf, s_flags = bs.sample(wo, r4, emissive)

        u_nee = st.next(2).to(dtype)
        u_sel = st.next().to(dtype)
        if has_env:
            use_env = u_sel < p_inf
            u_area = torch.where(p_inf < 1.0, (u_sel - p_inf) / torch.clamp(
                1.0 - p_inf, min=1e-20), 0.0)
            e_li, e_wi, e_dist, e_pdf = dl._sample_env(env, u_nee)
            a_li, a_wi, a_dist, a_pdf, a_p = _sample_area(
                t, pos, u_area, u_nee, dtype, nee_texel)
            s = use_env[:, None]
            li, wi_w = torch.where(s, e_li, a_li), torch.where(s, e_wi, a_wi)
            ldist = torch.where(use_env, e_dist, a_dist)
            lpdf = torch.where(use_env, e_pdf, a_pdf)
            p_light = torch.where(use_env, p_inf, (1.0 - p_inf) * a_p)
        else:
            li, wi_w, ldist, lpdf, p_light = _sample_area(
                t, pos, u_sel, u_nee, dtype, nee_texel)
        wi_l = torch.stack([pt._dot(wi_w, ft), pt._dot(wi_w, fb),
                            pt._dot(wi_w, fn)], -1)
        ev_f, ev_pdf = bs.evaluate(wo, wi_l)
        do_nee = hit & bs.wants_nee() & (torch.sum(ev_f * ev_f, -1) > 0.0)
        ld = li * ev_f * torch.abs(wi_l[:, 2:3]) / torch.clamp(
            p_light * lpdf + ev_pdf, min=1e-20)[:, None]
        sh_ld = torch.where(do_nee[:, None], atten * ld, 0.0)
        sh_max = torch.where(do_nee, ldist, 0.0) - pt.RAY_EPS

        cont = (s_flags & (pt.SAMPLE_REFLECTED | pt.SAMPLE_TRANSMITTED)) != 0
        atten_new = atten * s_f * torch.abs(s_wi[:, 2:3]) / torch.clamp(
            s_pdf, min=1e-20)[:, None]
        u_rr = st.next().to(dtype)
        q = torch.clamp(1.0 - torch.amax(atten_new, -1), min=0.0)
        if bounce == 0:
            q = torch.zeros_like(q)
        atten_new = atten_new / torch.clamp(1.0 - q, min=1e-20)[:, None]
        active_new = hit & cont & (s_pdf > 0.0) & ~(u_rr < q)
        wi_next = pt._normalize(ft * s_wi[:, 0:1] + fb * s_wi[:, 1:2]
                                + fn * s_wi[:, 2:3])
        o = torch.where(hit[:, None], pos, o)
        d = torch.where(hit[:, None], wi_next, d)
        atten = torch.where(active_new[:, None], atten_new, atten)
        active = active_new
        prev_pdf = torch.where(hit, s_pdf, prev_pdf)
        prev_spec = torch.where(hit, (s_flags & (pt.SAMPLE_SPECULAR
                                                 | pt.SAMPLE_TRANSMITTED)) != 0,
                                prev_spec)

        sidx = torch.nonzero(do_nee)[:, 0]
        if sidx.numel():
            _, _, _, _, s_hit = tracer.closest(pos[sidx], wi_w[sidx],
                                               pt.RAY_EPS, sh_max[sidx])
            clear = torch.zeros(n, dtype=torch.bool, device=dev)
            clear[sidx] = ~s_hit
            L = L + torch.where(clear[:, None], sh_ld, 0.0)
    return L.float()


def radiance(arrays: dict, width: int, height: int, max_bounces: int,
             pixels, samples, light_rows, device, dtype=torch.float32,
             estimator: str = "gltf"):
    """pathtracer.radiance's entry. `estimator="untextured_nee"` is the
    control that leaves the emission texel out of NEE (module
    docstring)."""
    if estimator not in ("gltf", "untextured_nee"):
        raise ValueError(f"unknown estimator {estimator!r}")
    scene = compile_scene(arrays, width, height)
    order, rows, total, gap = scene_lights(scene, light_rows, dtype)
    t = device_tables(scene, order, rows, total, device, dtype)
    env = dl._environment(arrays, device, dtype)
    tracer = pt.Tracer(t)
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.long, device=device)
    smp = torch.as_tensor(np.asarray(samples), dtype=torch.long, device=device)
    lane_pix = pix.repeat_interleave(len(smp))
    lane_smp = smp.repeat(len(pix))
    out = torch.empty((lane_pix.shape[0], 3), dtype=torch.float32,
                      device=device)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        step = 1 << 16
        for a in range(0, lane_pix.shape[0], step):
            p = lane_pix[a:a + step]
            out[a:a + step] = render_lanes(
                t, env, tracer, p % width, p // width, lane_smp[a:a + step],
                max_bounces, dtype, nee_texel=estimator == "gltf")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out.reshape(len(pix), len(smp), 3), gap
