"""The plain reference of the test cell: direct light alone (max_bounces
1) from area lights and an equirectangular environment, on opaque
dielectric and metal lobes, with uniform base-colour textures and
uniform normal maps. It imports the shared parts of
portbench/reference/pathtracer.py and writes only what it adds: the
textures folded into the materials, the tilted shading normal, the
environment (its pixels, alias table and lookups, worked out again from
the scene's arrays) and the choice between it and the area lights, as
the program's integrator makes it. Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import pathtracer as pt

ENV_DISTANCE = 1e7


def _texel(arrays, name):
    """The one texel of a uniform texture, linear float32 RGBA."""
    d = np.asarray(arrays["textures"][name]["data"])
    f = d.astype(np.float32) / np.float32(255.0) if d.dtype == np.uint8 \
        else d.astype(np.float32)
    if arrays["textures"][name]["format"] != "linear_rgba" or not (
            f == f[:1, :1]).all():
        raise ValueError("the test reference takes uniform linear textures")
    return f[0, 0]


def _fold(arrays):
    """(arrays without textures or environment, each material's
    tangent-space normal or None): a base-colour texel replaces the base
    colour, as the program's shading does."""
    mats, normals = {}, []
    for k, m in arrays["materials"].items():
        m = dict(m)
        slots = m.pop("textures", {})
        if set(slots) - {"base_color", "normal"}:
            raise ValueError("the test reference takes base_color and "
                             "normal textures only")
        if "base_color" in slots:
            m["base_color"] = tuple(_texel(arrays, slots["base_color"]))
        normals.append(_texel(arrays, slots["normal"])[:3] * 2.0 - 1.0
                       if "normal" in slots else None)
        mats[k] = m
    folded = {k: v for k, v in arrays.items()
              if k not in ("textures", "environment")}
    folded["materials"] = mats
    return folded, normals


def _environment(arrays, device, dtype):
    """The environment's pixels (H, W, 3) and alias table, or None."""
    env = arrays.get("environment")
    if env is None:
        return None
    f32 = np.float32
    if env.get("texture") is not None:
        d = np.asarray(arrays["textures"][env["texture"]]["data"])
        px = (d.astype(f32) / f32(255.0) if d.dtype == np.uint8
              else d.astype(f32))[..., :3]
    else:
        px = np.asarray(env["constant_color"], f32).reshape(1, 1, 3)
    px = (px @ pt._bt709_identity().T * f32(env["strength"])).astype(f32)
    if not px.max() > 0.0:
        return None

    def xyz(xy):
        return np.array([xy[0], xy[1], 1.0 - xy[0] - xy[1]], np.float64)
    prim = np.stack([xyz((0.64, 0.33)), xyz((0.30, 0.60)),
                     xyz((0.15, 0.06))], axis=1)
    w = xyz((0.3127, 0.3290))
    luma_w = (prim * np.linalg.solve(prim, w / w[1])[None, :])[1].astype(f32)
    luma = np.maximum(px @ luma_w, 0.0).reshape(-1).astype(np.float64)
    p, alias = pt.alias_table(luma)
    pdf = (luma * (len(luma) / luma.sum())).astype(f32)

    def t(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                            dtype=dt)
    return dict(pixels=t(px), pdf=t(pdf), p=t(p), alias=t(alias, torch.long))


def _env_uv(d):
    phi = torch.atan2(-d[..., 2], -d[..., 0])
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return torch.stack([phi / (2.0 * np.pi), theta / np.pi], -1)


def _env_dir(uv):
    y = torch.cos(uv[..., 1] * np.pi)
    r = torch.sin(uv[..., 1] * np.pi)
    phi = uv[..., 0] * 2.0 * np.pi
    return pt._normalize(torch.stack([-torch.cos(phi) * r, y,
                                      -torch.sin(phi) * r], -1))


def _env_radiance(env, d):
    """Bilinear, x wrapped, y clamped."""
    px = env["pixels"]
    h, w = px.shape[:2]
    uv = _env_uv(d)
    x = uv[..., 0] * w - 0.5
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    return ((px[y0i, x0i] * (1 - fx) + px[y0i, x1i] * fx) * (1 - fy)
            + (px[y1i, x0i] * (1 - fx) + px[y1i, x1i] * fx) * fy)


def _sample_env(env, u2):
    """(li, wi, dist, solid-angle pdf) of an alias-table draw, jittered
    inside the texel."""
    h, w = env["pixels"].shape[:2]
    n = h * w
    scaled = u2[:, 0] * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    ux = torch.clamp(scaled - slot.to(scaled.dtype), 0.0, 1.0)
    p_slot = env["p"][slot]
    alias = u2[:, 1] >= p_slot
    i = torch.where(alias, env["alias"][slot], slot)
    uy = torch.where(alias,
                     (u2[:, 1] - p_slot) / torch.clamp(1.0 - p_slot, min=1e-9),
                     u2[:, 1] / torch.clamp(p_slot, min=1e-9))
    uy = torch.clamp(uy, 0.0, 1.0 - 1e-6)
    uv = torch.stack([((i % w).to(ux.dtype) + ux) / w,
                      ((i // w).to(ux.dtype) + uy) / h], -1)
    wi = _env_dir(uv)
    sin_t = torch.sin(uv[:, 1] * np.pi)
    pdf = env["pdf"][i] / (2.0 * np.pi * np.pi
                           * torch.clamp(sin_t, min=1e-4))
    return (_env_radiance(env, wi), wi,
            torch.full_like(pdf, ENV_DISTANCE), pdf)


def _from_normal(n):
    a = torch.where((torch.abs(n[:, 0]) > 0.5)[:, None],
                    pt._const([0.0, 0.0, 1.0], n), pt._const([1.0, 0.0, 0.0], n))
    b = pt._normalize(pt._cross(n, a))
    return pt._cross(n, b), b, n


def _lanes(t, env, nrm, has_nrm, tracer, px, py, sample, dtype):
    """(R, 3) radiance of one sample of each lane: the camera ray's
    emission or environment, then one light sample with MIS weights."""
    dev = px.device
    n = px.shape[0]
    st = pt.Halton(px, py, sample)
    jit = st.next(2).to(dtype)
    st.next(2)                          # the lens draw
    film = (t["cam_top_left"] + (px.to(dtype) + jit[:, 0])[:, None]
            * t["cam_du"] + (py.to(dtype) + jit[:, 1])[:, None] * t["cam_dv"])
    o = t["cam_pos"].expand(n, 3).clone()
    d = pt._normalize(film - o)
    inf = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    th, tri, u, v, hit = tracer.closest(o, d, pt.RAY_EPS, inf)
    normal, tangent, sign, _, mat = pt._interpolate(t, tri, u, v, o, d, hit)
    tt = torch.where(hit, th, 0.0)
    if dtype == torch.float32:
        pos = (o.double() + d.double() * tt.double()[:, None]).float()
    else:
        pos = o + d * tt[:, None]
    ft, fb, fn = pt._frame(normal, tangent, sign)
    tilted = pt._normalize(ft * nrm[mat][:, 0:1] + fb * nrm[mat][:, 1:2]
                           + fn * nrm[mat][:, 2:3])
    mt, mb, mn = _from_normal(tilted)
    sel = has_nrm[mat][:, None]
    ft, fb, fn = (torch.where(sel, a, b) for a, b in ((mt, ft), (mb, fb),
                                                      (mn, fn)))
    wo = torch.stack([pt._dot(-d, ft), pt._dot(-d, fb), pt._dot(-d, fn)], -1)
    bs = pt.Bsdf(t, mat)
    L = torch.where(hit[:, None], bs.emitted(t), 0.0)
    if env is not None:
        L = L + torch.where(hit[:, None], 0.0, _env_radiance(env, d))

    st.next(2)                          # the BSDF sample's draws
    st.next()
    st.next()
    st.next(2)                          # the coat's draw
    u_nee = st.next(2).to(dtype)
    u_sel = st.next().to(dtype)
    n_lights = t["lights"].shape[0]
    if env is None:
        li, wi, dist, lpdf, p_light = pt._sample_light(t, pos, u_sel, u_nee)
    else:
        p_inf = 0.5 if n_lights else 1.0
        use_env = u_sel < p_inf
        u_area = torch.where(use_env, 0.0, (u_sel - p_inf) / (1.0 - p_inf)) \
            if n_lights else u_sel
        e_li, e_wi, e_dist, e_pdf = _sample_env(env, u_nee)
        a_li, a_wi, a_dist, a_pdf, a_p = pt._sample_light(t, pos, u_area,
                                                          u_nee)
        s = use_env[:, None]
        li, wi = torch.where(s, e_li, a_li), torch.where(s, e_wi, a_wi)
        dist = torch.where(use_env, e_dist, a_dist)
        lpdf = torch.where(use_env, e_pdf, a_pdf)
        p_light = torch.where(use_env, p_inf, (1.0 - p_inf) * a_p)
    wi_l = torch.stack([pt._dot(wi, ft), pt._dot(wi, fb), pt._dot(wi, fn)],
                       -1)
    ev_f, ev_pdf = bs.evaluate(wo, wi_l)
    do_nee = hit & bs.wants_nee() & (torch.sum(ev_f * ev_f, -1) > 0.0)
    ld = li * ev_f * torch.abs(wi_l[:, 2:3]) / torch.clamp(
        p_light * lpdf + ev_pdf, min=1e-20)[:, None]
    sidx = torch.nonzero(do_nee)[:, 0]
    if sidx.numel():
        _, _, _, _, s_hit = tracer.closest(pos[sidx], wi[sidx], pt.RAY_EPS,
                                           dist[sidx] - pt.RAY_EPS)
        clear = torch.zeros(n, dtype=torch.bool, device=dev)
        clear[sidx] = ~s_hit
        L = L + torch.where(clear[:, None], ld, 0.0)
    return L.float()


def radiance(arrays: dict, width: int, height: int, max_bounces: int,
             pixels, samples, light_rows, device, dtype=torch.float32):
    """pathtracer.radiance's entry, for direct light alone."""
    if max_bounces != 1:
        raise ValueError("the test reference renders direct light alone "
                         "(max_bounces 1)")
    folded, normals = _fold(arrays)
    scene = pt.compile_scene(folded, width, height)
    rows, total, gap = pt.scene_lights(scene, light_rows, dtype)
    t = pt.device_tables(scene, rows, total, device, dtype)
    env = _environment(arrays, device, dtype)
    nrm = torch.tensor(np.stack([x if x is not None else np.zeros(3, np.float32)
                                 for x in normals]), dtype=dtype, device=device)
    has_nrm = torch.tensor([x is not None for x in normals], device=device)
    tracer = pt.Tracer(t)
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.long, device=device)
    smp = torch.as_tensor(np.asarray(samples), dtype=torch.long, device=device)
    lane_pix = pix.repeat_interleave(len(smp))
    rad = _lanes(t, env, nrm, has_nrm, tracer, lane_pix % width,
                 lane_pix // width, smp.repeat(len(pix)), dtype)
    return rad.reshape(len(pix), len(smp), 3), gap
