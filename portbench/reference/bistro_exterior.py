"""The plain reference of `bistro_exterior`: a street of textured,
opaque and alpha-cut (cutout) metal-rough surfaces under an HDR sky with
many small emitters, path traced with the program's documented estimator
in plain PyTorch and NumPy.

It imports nothing of the program. It takes helmet_env.py's reference
whole for what the two scenes share (the textured materials and their
bilinear u8 taps, the sky and its split with the area lights, textured
NEE, the energy terms from the LUTs, the light-row match) and
pathtracer.py's parts (the Halton sampler, the BSDF's lobes, the
box-culled tracer), and adds what neither covers:
- cutouts: a material is alpha-tested where its base-colour factor's
  alpha is below one or its base-colour map has a texel of alpha below
  255 (the glTF loader's rule); its opacity at a hit is the factor's
  alpha times the bilinear tap of the map's alpha at the hit's uv, and 1
  on every other material;
- the path segment's hops: after a segment's closest hit, ALPHA_HOPS
  times, a draw (before the test) against the hit's opacity; a hit that
  passes moves the segment's origin to the hit point and traces again,
  a hit that fails is settled and tested never again, and after the last
  hop the segment shades whatever it hit last as opaque. The hop origin
  is the shading position's origin, the previous path vertex the MIS
  distance's;
- the shadow segment's waves: up to ALPHA_HOPS + 1 closest-hit traces
  over the segment's remaining length, each followed by a draw (after
  its trace); a hit blocks where the draw falls below its opacity, else
  the segment goes on from the hit point with its length shortened by
  the hit's distance, and a segment still unresolved after the last wave
  is occluded;
- a tracer of two box levels: the triangles in clusters of 64 along a
  Morton curve (helmet_env.py's), and the clusters in groups of 64, so
  that a ray tests the groups, then the clusters of the groups it meets,
  then the triangles of the clusters it meets.
The bounce loop, Russian roulette and the sampler's dimensions are the
program's, to `max_bounces` bounces: each bounce draws its two hops
first, then the BSDF's and NEE's draws, then the shadow's three, then
Russian roulette's.

Departures from glTF, each the program's documented estimator:
- alphaMode MASK with its cutoff is a stochastic pass-through: a hit
  passes with probability one less its opacity. The two agree where the
  opacity is 0 or 1, which is every texel but the leaves' edges;
- the hop budget: a path segment tests at most ALPHA_HOPS = 2 hits and
  shades its third as opaque, a shadow segment resolves at most
  ALPHA_HOPS + 1 = 3 and is occluded past them;
- glTF's doubleSided is not modelled: a card's back shades as any back
  face does (BSDF sampling, no NEE);
- and helmet_env.py's (emission scaled by (1 - metal) on a hit, the
  base-colour texture replacing the factor, the energy-compensated
  lobes, u8 taps filtered after decoding, no smooth lobes).

`estimator="opaque"` is the control of the cutouts: every opacity 1 (the
draws still made), the leaves rendered as opaque cards, which must come
out as not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import helmet_env as he
from portbench.reference import pathtracer as pt
from portbench.testcell.reference import direct_light as dl

ALPHA_HOPS = 2
GROUP = 64          # clusters a group


def compile_scene(arrays: dict, width: int, height: int) -> dict:
    """helmet_env.compile_scene's tables with each material's alpha
    factor and cutout flag, and the clusters' groups and their boxes."""
    scene = he.compile_scene(arrays, width, height)
    mats = [dict(pt.MATERIAL_DEFAULTS, **m) for m in arrays["materials"].values()]
    factor = np.array([float(m["base_color"][3]) if len(m["base_color"]) > 3
                       else 1.0 for m in mats], np.float32)
    cut = []
    for m, a in zip(mats, factor):
        tex = m.get("textures", {}).get("base_color")
        d = np.asarray(arrays["textures"][tex]["data"]) if tex else None
        cut.append(a < 1.0 or (d is not None and d.ndim == 3
                               and d.shape[2] >= 4
                               and bool((d[..., 3] < 255).any())))
    lo, hi = scene["inst_lo"], scene["inst_hi"]
    n = len(lo)
    starts = np.arange(0, n, GROUP)
    glo = np.minimum.reduceat(lo, starts, axis=0)
    ghi = np.maximum.reduceat(hi, starts, axis=0)
    scene.update(alpha_factor=factor, uses_alpha=np.array(cut),
                 group_lo=glo, group_hi=ghi)
    return scene


class GroupTracer(pt.Tracer):
    """pathtracer.Tracer over clusters (every "instance" a cluster of at
    most 64 triangles), whose ray-box pairs come from a first level of
    groups of GROUP clusters."""

    def __init__(self, tables):
        super().__init__(tables)
        self.glo, self.ghi = tables["group_lo"], tables["group_hi"]
        self.n_clusters = self.lo.shape[0]

    @staticmethod
    def _slab(oo, ii, lo, hi, tmin, tmax):
        t1, t2 = (lo - oo) * ii, (hi - oo) * ii
        tn = torch.amax(torch.minimum(t1, t2), -1)
        tf = torch.amin(torch.maximum(t1, t2), -1)
        return (tn <= tf) & (tf >= tmin) & (tn <= tmax)

    def _boxes(self, o, d, tmin, tmax):
        d_safe = torch.where(torch.abs(d) < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)
        inv = 1.0 / d_safe
        r1, g1 = [], []
        step = max(1, self.PAIR_BUDGET // max(1, len(self.glo)))
        for a in range(0, o.shape[0], step):
            hit = self._slab(o[a:a + step, None, :], inv[a:a + step, None, :],
                             self.glo[None], self.ghi[None], tmin,
                             tmax[a:a + step, None])
            r, g = torch.nonzero(hit, as_tuple=True)
            r1.append(r + a)
            g1.append(g)
        r1, g1 = torch.cat(r1), torch.cat(g1)
        k = torch.arange(GROUP, device=o.device)
        rays, insts = [], []
        step = max(1, self.PAIR_BUDGET // GROUP)
        for a in range(0, r1.shape[0], step):
            rr, gg = r1[a:a + step], g1[a:a + step]
            cl = gg[:, None] * GROUP + k[None]
            valid = cl < self.n_clusters
            cl = torch.clamp(cl, max=self.n_clusters - 1)
            hit = valid & self._slab(o[rr][:, None, :], inv[rr][:, None, :],
                                     self.lo[cl], self.hi[cl], tmin,
                                     tmax[rr][:, None])
            r, j = torch.nonzero(hit, as_tuple=True)
            rays.append(rr[r])
            insts.append(cl[r, j])
        if not rays:
            e = torch.zeros(0, dtype=torch.long, device=o.device)
            return e, e
        return torch.cat(rays), torch.cat(insts)


def _hit_uv(t, tri, u, v):
    w = (1.0 - u - v)[:, None]
    tuv = t["uvs"][tri]
    return tuv[:, 0:2] * w + tuv[:, 2:4] * u[:, None] + tuv[:, 4:6] * v[:, None]


def _point(o, d, tt, dtype):
    """o + d * t, formed in float64 and rounded once in float32 (the
    program's hit point), else in `dtype`."""
    if dtype == torch.float32:
        return (o.double() + d.double() * tt.double()[:, None]).float()
    return o + d * tt[:, None]


def opacity(t, tri, uv, dtype, cutouts: bool = True):
    """(R,) opacity at hits on triangles `tri` at `uv`: the factor's alpha
    times the base-colour map's alpha tap on a cutout material, 1
    elsewhere (and everywhere without `cutouts`)."""
    mat = t["tri_mat"][tri]
    has, base = he._slot(t, mat, 0, uv, dtype)
    a = t["alpha_factor"][mat] * torch.where(has, base[:, 3], 1.0)
    return torch.where(t["uses_alpha"][mat] & cutouts, a, 1.0)


def _trace(tracer, o, d, tmax, lanes, dtype):
    """Closest hits of the rays `lanes` (a mask), scattered back: (t, tri,
    u, v, hit), misses and other lanes hit False."""
    n = o.shape[0]
    dev = o.device
    t_all = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    tri_all = torch.zeros(n, dtype=torch.long, device=dev)
    u_all = torch.zeros(n, dtype=dtype, device=dev)
    v_all = torch.zeros(n, dtype=dtype, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.nonzero(lanes)[:, 0]
    if idx.numel():
        th, trh, uh, vh, hh = tracer.closest(o[idx], d[idx], pt.RAY_EPS,
                                             tmax[idx])
        t_all[idx], tri_all[idx], u_all[idx], v_all[idx], hit[idx] = \
            th, trh, uh, vh, hh
    return t_all, tri_all, u_all, v_all, hit


def render_lanes(t, env, tracer, px, py, sample, max_bounces, dtype,
                 cutouts: bool = True):
    """(R, 3) radiance of one sample of each lane, the program's bounce
    loop with its alpha hops lane by lane."""
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
        t_all, tri_all, u_all, v_all, hit = _trace(tracer, o, d, inf, active,
                                                   dtype)
        # the path hops: a draw, then the test of a hit not yet tested
        u_hop = st.next(ALPHA_HOPS).to(dtype).reshape(n, ALPHA_HOPS)
        o_eff = o
        settled = torch.zeros_like(hit)
        for h in range(ALPHA_HOPS):
            cand = hit & active & ~settled
            tri = torch.where(hit, tri_all, 0)
            a = opacity(t, tri, _hit_uv(t, tri, u_all, v_all), dtype, cutouts)
            pas = cand & (u_hop[:, h] >= a)
            settled = settled | (cand & ~pas)
            o_eff = torch.where(pas[:, None], _point(
                o_eff, d, torch.where(hit, t_all, 0.0), dtype), o_eff)
            t2, tri2, u2, v2, hit2 = _trace(tracer, o_eff, d, inf, pas, dtype)
            t_all = torch.where(pas, t2, t_all)
            tri_all = torch.where(pas, tri2, tri_all)
            u_all = torch.where(pas, u2, u_all)
            v_all = torch.where(pas, v2, v_all)
            hit = torch.where(pas, hit2, hit)
        miss = active & ~hit
        hit = hit & active
        if has_env:
            env_le = dl._env_radiance(env, d)
            w_env = torch.where(prev_spec, 1.0, prev_pdf / torch.clamp(
                prev_pdf + he._env_pdf(env, d) * p_inf, min=1e-20))
            L = L + torch.where(miss[:, None], atten * env_le * w_env[:, None],
                                0.0)

        normal, tangent, sign, gnormal, mat = pt._interpolate(
            t, tri_all, u_all, v_all, o_eff, d, hit)
        tri = torch.where(hit, tri_all, 0)
        uv = _hit_uv(t, tri, u_all, v_all)
        pos = _point(o_eff, d, torch.where(hit, t_all, 0.0), dtype)
        ft, fb, fn = pt._frame(normal, tangent, sign)

        albedo, rough = t["albedo"][mat], t["rough"][mat]
        metal, emission = t["metal"][mat], t["emission"][mat]
        has, base = he._slot(t, mat, 0, uv, dtype)
        albedo = torch.where(has[:, None], base[:, :3], albedo)
        has, rm = he._slot(t, mat, 1, uv, dtype)
        rough = rough * torch.where(has, rm[:, 0], 1.0)
        metal = metal * torch.where(has, rm[:, 1], 1.0)
        has, em = he._slot(t, mat, 2, uv, dtype)
        emission = emission * torch.where(has[:, None], em[:, :3], 1.0)
        has, nm = he._slot(t, mat, 3, uv, dtype)
        nm = nm[:, :3] * 2.0 - 1.0
        mapped = pt._normalize(ft * nm[:, 0:1] + fb * nm[:, 1:2]
                               + fn * nm[:, 2:3])
        mt, mb, mn = dl._from_normal(mapped)
        sel = has[:, None]
        ft, fb, fn = (torch.where(sel, x, y) for x, y in ((mt, ft), (mb, fb),
                                                          (mn, fn)))
        wo = torch.stack([pt._dot(-d, ft), pt._dot(-d, fb), pt._dot(-d, fn)],
                         -1)
        emissive = t["emissive"][mat]
        bs = he.TexturedBsdf(t["luts"], albedo, rough, metal, t["ior"][mat],
                             emission, emissive)

        le = bs.emitted()
        cos_hit = torch.abs(pt._dot(d, gnormal))
        # the distance from the previous path vertex, not from the hop's
        # origin: the pdf NEE would have used
        dist2 = torch.sum((pos - o) ** 2, -1)
        light_pdf = ((1.0 - p_inf) * (t["emission"][mat][:, 1] * np.pi
                                      / torch.clamp(t["total_power"],
                                                    min=1e-20))
                     * dist2 / torch.clamp(cos_hit, min=1e-20))
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
            # a lane that takes the sky discards its area sample; its draw
            # is clamped at 0 so that in bfloat16 its product with the
            # light count (18,000 rounds to 18,048) stays a valid index
            u_area = torch.where(p_inf < 1.0, torch.clamp(
                (u_sel - p_inf) / torch.clamp(1.0 - p_inf, min=1e-20),
                min=0.0), 0.0)
            e_li, e_wi, e_dist, e_pdf = dl._sample_env(env, u_nee)
            a_li, a_wi, a_dist, a_pdf, a_p = he._sample_area(
                t, pos, u_area, u_nee, dtype, True)
            s = use_env[:, None]
            li, wi_w = torch.where(s, e_li, a_li), torch.where(s, e_wi, a_wi)
            ldist = torch.where(use_env, e_dist, a_dist)
            lpdf = torch.where(use_env, e_pdf, a_pdf)
            p_light = torch.where(use_env, p_inf, (1.0 - p_inf) * a_p)
        else:
            li, wi_w, ldist, lpdf, p_light = he._sample_area(
                t, pos, u_sel, u_nee, dtype, True)
        wi_l = torch.stack([pt._dot(wi_w, ft), pt._dot(wi_w, fb),
                            pt._dot(wi_w, fn)], -1)
        ev_f, ev_pdf = bs.evaluate(wo, wi_l)
        do_nee = hit & bs.wants_nee() & (torch.sum(ev_f * ev_f, -1) > 0.0)
        ld = li * ev_f * torch.abs(wi_l[:, 2:3]) / torch.clamp(
            p_light * lpdf + ev_pdf, min=1e-20)[:, None]
        sh_ld = torch.where(do_nee[:, None], atten * ld, 0.0)
        # the shadow waves' draws, one after each wave's trace
        u_sh = st.next(ALPHA_HOPS + 1).to(dtype).reshape(n, ALPHA_HOPS + 1)

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

        # the shadow segment through cutouts
        org, rem = pos, ldist - pt.RAY_EPS
        occluded = torch.zeros_like(do_nee)
        clear = torch.zeros_like(do_nee)
        for h in range(ALPHA_HOPS + 1):
            qry = do_nee & ~occluded & ~clear
            s_t, s_tri, s_u, s_v, s_hit = _trace(tracer, org, wi_w, rem, qry,
                                                 dtype)
            shit = s_hit & qry
            clear = clear | (qry & ~s_hit)
            tri = torch.where(s_hit, s_tri, 0)
            a = opacity(t, tri, _hit_uv(t, tri, s_u, s_v), dtype, cutouts)
            blocked = shit & (u_sh[:, h] < a)
            occluded = occluded | blocked
            pas = shit & ~blocked
            org = torch.where(pas[:, None], _point(
                org, wi_w, torch.where(s_hit, s_t, 0.0), dtype), org)
            rem = torch.where(pas, rem - s_t, rem)
        occluded = occluded | (do_nee & ~clear & ~occluded)

        o = torch.where(hit[:, None], pos, o)
        d = torch.where(hit[:, None], wi_next, d)
        atten = torch.where(active_new[:, None], atten_new, atten)
        active = active_new
        prev_pdf = torch.where(hit, s_pdf, prev_pdf)
        prev_spec = torch.where(hit, (s_flags & (pt.SAMPLE_SPECULAR
                                                 | pt.SAMPLE_TRANSMITTED)) != 0,
                                prev_spec)
        L = L + torch.where((do_nee & ~occluded)[:, None], sh_ld, 0.0)
    return L.float()


def radiance(arrays: dict, width: int, height: int, max_bounces: int,
             pixels, samples, light_rows, device, dtype=torch.float32,
             estimator: str = "gltf"):
    """pathtracer.radiance's entry. `estimator="opaque"` is the control
    that makes every cutout opaque (module docstring)."""
    if estimator not in ("gltf", "opaque"):
        raise ValueError(f"unknown estimator {estimator!r}")
    scene = compile_scene(arrays, width, height)
    order, rows, total, gap = he.scene_lights(scene, light_rows, dtype)
    t = he.device_tables(scene, order, rows, total, device, dtype)
    env = dl._environment(arrays, device, dtype)
    tracer = GroupTracer(t)
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
                max_bounces, dtype, cutouts=estimator == "gltf")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out.reshape(len(pix), len(smp), 3), gap
