"""Progressive path-tracing integrator, wavefront over bounces, in torch.

Port of platinum_tpu/render/integrator.py: all rays of a sample advance in
lockstep through a masked bounce loop (trace -> env/emission -> BSDF
sample -> NEE shadow trace -> update) with per-lane active masks. The JAX
`lax.while_loop` is a Python loop that stops after `max_bounces` or when
no lane is active. The estimator, including its documented deviations
from the Metal reference, is the JAX package's.

With `settings.compact` the wavefront shrinks on a schedule of
(cap, bounce_limit) segments (`_compaction_plan`, or a measured plan from
render/autoplan.py): between segments `_compact_state` keeps a uniform
random subset of the live lanes, drawn from the same threefry bits as the
JAX package (ops/threefry.py), so the two select the same lanes.

The packet tracer takes the scene's octant orders when
`settings.oct_order` (K7), its streamed blocks when `flat.wbvh_stream`
(K6) and the MT tier `settings.mt_precision` (K4, K5), as the JAX
make_tracers does; none of them is ever dropped: a combination the
kernel cannot run raises.

The three wave-shaping modes are the JAX package's. `fuse_shadow` defers
bounce k's shadow rays onto bounce k+1's closest-hit wave as extra lanes
(one trace launch per bounce instead of two); what is still pending is
settled by `body.resolve_pending` before every compaction and at the end.
`chunk_shade` shades only the lanes that hit, in fixed-size chunks (a
Python loop here, where the JAX package runs a `while_loop`).
`spp_batch = B` traces B samples of every pixel in one wavefront and
returns their per-pixel sum.

`tracer="bf"` traces closest-hit waves with the breadth-first tracer of
ops/bfstream.py (K10-K14) and any-hit waves with the packet kernel (K2),
as the JAX make_tracers does; a scene without a wide BVH falls through to
the brute tracer there too.

Textured scenes sample the atlas in shading (ops/texturing.py): the
material textures in `make_shading_context` and, where a material binds
one, the normal map, which tilts the shading frame (JAX
integrator.py:306-339).

Alpha-tested (cutout) materials take the JAX package's stochastic
pass-through loops (`ALPHA_HOPS`): a path segment re-traces from a cutout
hit that passes its draw, testing each hit once, and a shadow segment
traces closest hits up to ALPHA_HOPS + 1 times instead of one any-hit
wave. Under alpha only the closest-hit mode of the tracer launches;
`fuse_shadow` and `chunk_shade` stay off, as in the JAX package.

Partitioned structures (FlatScene.wbvh_parts) trace through
accel/partition.py's sequential tracer, one packet tracer pair per
partition. `render_sample(pixel_ids=)` renders a subset of the pixels,
the shard a rank of the multi-device path (parallel/) renders.

`tracer="bvh"` (and "auto" on a scene with a binary BVH and no wide one)
traces with the binary-BVH walk of ops/traverse.py, as in the JAX
package; the ray-stream tracer of ops/raystream.py is reached through
`tracers=`. `render_sample_stepped` is the JAX package's host-driven
bounce loop (one `bounce_step` a bounce, stopping once no lane is
active).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from platinum_tpu_torch.core.material import TextureSlot
from platinum_tpu_torch.models import bsdf as bsdf_mod
from platinum_tpu_torch.models import lights as lights_mod
from platinum_tpu_torch.models.camera_rays import spawn_camera_rays
from platinum_tpu_torch.ops import samplers as smp
from platinum_tpu_torch.ops import threefry
from platinum_tpu_torch.ops.frame import (from_normal, norm, normalize,
                                          world_to_local)
from platinum_tpu_torch.ops.hitdata import interpolate_hit
from platinum_tpu_torch.ops.intersect import HitRecord, make_brute_tracer
from platinum_tpu_torch.ops.texturing import (sample_base_alpha,
                                              sample_normal_map)
from platinum_tpu_torch.render.types import (MAT_USES_ALPHA, FlatScene,
                                             RenderSettings)

RAY_EPS = 1e-3
# Alpha-cutout layers crossed per segment without consuming a bounce (the
# reference's bounded any-hit loop, intersections.metal:8-39): path
# segments re-test at most ALPHA_HOPS stacked cutout surfaces (deeper
# stacks shade the last hit as opaque); shadow segments resolve
# ALPHA_HOPS + 1 layers and treat anything still unresolved as occluded.
ALPHA_HOPS = 2


def _alpha_value(flat: FlatScene, mat_idx, uv):
    """Opacity at a hit: the material's base alpha times its base-colour
    texture's alpha; 1 for materials without the USES_ALPHA flag."""
    packed = flat.materials.packed[mat_idx.long()]
    base_a = packed[:, 3]
    flags = packed[:, 15].to(torch.int32)
    if flat.atlas is not None:
        tex_rows = flat.materials.textures[mat_idx.long()]
        base_a = base_a * sample_base_alpha(flat.atlas, flat.atlas_table,
                                            tex_rows, uv)
    return torch.where((flags & MAT_USES_ALPHA) != 0, base_a, 1.0)


def make_tracers(flat: FlatScene, settings: RenderSettings):
    """(trace_closest, trace_any) for the scene: the wide-BVH packet
    tracer for "packet"/"auto" when the scene has one (with the octant
    order, streamed blocks and MT tier of JAX integrator.py:92-101); for
    "bf" the breadth-first tracer's closest hit at the tier beside the
    packet tracer's any hit, which is fp32 under every tier (JAX
    integrator.py:66-85; the breadth-first tracer refuses two_phase); over
    partitions (FlatScene.wbvh_parts) the sequential partitioned tracer
    (accel/partition.py), taken before the single structure as in JAX
    integrator.py:86-89; else brute force. Options raise where they
    cannot be honoured: an unknown tier, two_phase over streamed blocks or
    with "bf", oct_order without octant orders, "bf" over an instanced or
    partitioned scene, and a tier or order asked of the bvh or brute
    tracer (JAX ignores them there). Past the packet tracer come, in JAX's
    order (integrator.py:102-111), the refusal of an instanced scene, the
    binary-BVH tracer (ops/traverse.py) for "bvh" / "auto" where the
    scene has a binary BVH, and brute force."""
    from platinum_tpu_torch.ops.packet_trace import make_packet_tracer

    if settings.tracer == "bf" and (flat.wbvh_nodes is not None
                                    or flat.wbvh_parts is not None):
        from platinum_tpu_torch.ops.bfstream import make_bf_tracer

        # a partitioned scene has no wbvh_nodes: refuse it here, not by
        # falling through to the brute tracer
        if flat.instances is not None or flat.wbvh_parts is not None:
            raise ValueError("tracer='bf' requires a plain resident tree: "
                             "instancing='off', no partitioning")
        bf_c, _ = make_bf_tracer(
            flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
            mt_precision=settings.mt_precision,
            depth=settings.bf_depth or None)
        # any hit is the fp32 test under every tier: no planes to split
        _, pk_a = make_packet_tracer(
            flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
            mt_precision="highest")
        return bf_c, pk_a
    if settings.tracer in ("packet", "auto") and flat.wbvh_parts is not None:
        from platinum_tpu_torch.accel.partition import make_partitioned_tracer

        return make_partitioned_tracer(flat.wbvh_parts,
                                       oct_order=settings.oct_order,
                                       mt_precision=settings.mt_precision)
    if settings.tracer in ("packet", "auto") and flat.wbvh_nodes is not None:
        if settings.oct_order and flat.wbvh_order is None:
            raise ValueError("oct_order=True needs the scene's octant "
                             "orders (FlatScene.wbvh_order)")
        return make_packet_tracer(
            flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
            inst_feat=(flat.instances.feat
                       if flat.instances is not None else None),
            worder=flat.wbvh_order if settings.oct_order else None,
            stream=flat.wbvh_stream, mt_precision=settings.mt_precision)
    bvh = settings.tracer in ("bvh", "auto") and flat.bvh_skip is not None
    if settings.oct_order or settings.mt_precision != "highest":
        raise ValueError(
            f"oct_order / mt_precision={settings.mt_precision!r} are "
            f"options of the packet kernel, and this scene traces with the "
            f"{'bvh' if bvh else 'brute'} tracer "
            f"(tracer={settings.tracer!r}, no wide BVH in use)")
    if flat.instances is not None:
        raise ValueError(
            "instanced FlatScene requires the packet tracer "
            "(settings.tracer='packet'/'auto'); rebuild with "
            "instancing='off' for the brute/bvh tracers")
    if bvh:
        from platinum_tpu_torch.ops.traverse import make_bvh_tracer

        return make_bvh_tracer(flat, max_leaf=settings.accel_max_leaf)
    return make_brute_tracer(flat.geometry)


def _fuse_shadow_active(settings: RenderSettings, features: frozenset) -> bool:
    return (settings.fuse_shadow and settings.kernel == "mis"
            and "alpha" not in features
            and ("env" in features or "area_lights" in features))


def _empty_shadow(n: int, dev):
    return dict(sh_org=torch.zeros((n, 3), device=dev),
                sh_dir=torch.zeros((n, 3), device=dev),
                sh_dist=torch.zeros((n,), device=dev),
                sh_ld=torch.zeros((n, 3), device=dev),
                sh_do=torch.zeros((n,), dtype=torch.bool, device=dev))


def init_path_state(flat: FlatScene, settings: RenderSettings, sample_idx,
                    pixel_ids=None, with_shadow_state: bool = False):
    """Camera rays + fresh path state for one sample of every pixel, or of
    the pixels `pixel_ids` (autoplan's probe; the lanes of a sample batch,
    with `sample_idx` one index per lane). `with_shadow_state` adds the
    empty deferred-shadow state of `fuse_shadow`."""
    dev = flat.camera.position.device
    pix = (torch.arange(settings.num_pixels, device=dev) if pixel_ids is None
           else torch.as_tensor(pixel_ids, device=dev).long())
    n = pix.shape[0]
    px = pix % settings.width
    py = pix // settings.width

    stream = smp.make_stream(settings.sampler, px, py, sample_idx,
                             settings.width, settings.height, settings.spp)
    stream, pixel_jitter = stream.next_2d()
    stream, lens_u = stream.next_2d()
    o, d = spawn_camera_rays(flat.camera, px, py, pixel_jitter, lens_u)

    return dict(
        o=o,
        d=d,
        L=torch.zeros((n, 3), device=dev),
        atten=torch.ones((n, 3), device=dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros((n,), device=dev),
        prev_spec=torch.ones((n,), dtype=torch.bool, device=dev),
        stream=stream,
        bounce=0,
        rays=torch.zeros((), device=dev),
        slot=torch.arange(n, dtype=torch.int32, device=dev),
        **(_empty_shadow(n, dev) if with_shadow_state else {}),
    )


def make_bounce_body(flat: FlatScene, settings: RenderSettings,
                     features: frozenset, tracers=None):
    """body(state) -> state for ONE bounce of the wavefront loop."""
    trace_closest, trace_any = tracers or make_tracers(flat, settings)
    geom, mats, lights, env = flat.geometry, flat.materials, flat.lights, flat.env
    luts = flat.luts
    multiscatter = bool(settings.flags & 1)

    use_mis = settings.kernel == "mis"
    env_on = "env" in features
    lights_on = "area_lights" in features
    has_env = env.count > 0 if env_on else False
    has_lights = lights.count > 0 if lights_on else False
    p_inf = (lights_mod.p_infinite(lights, env) if (env_on and lights_on)
             else (1.0 if env_on else 0.0))

    alpha_on = "alpha" in features
    fuse_shadow = _fuse_shadow_active(settings, features)
    tex_slots = frozenset(
        int(f[len("texslot"):]) for f in features if f.startswith("texslot"))
    normal_map = (flat.atlas is not None
                  and int(TextureSlot.NORMAL) in tex_slots)

    def body(s):
        o, d, atten, L, active = s["o"], s["d"], s["atten"], s["L"], s["active"]
        bounce = s["bounce"]
        n = o.shape[0]
        dev = o.device

        if fuse_shadow:
            # last bounce's shadow rays ride this closest wave as n more
            # lanes: a shadow lane is clear when nothing is hit before
            # its light
            rec2 = trace_closest(
                torch.cat([o, s["sh_org"]]), torch.cat([d, s["sh_dir"]]),
                RAY_EPS,
                torch.cat([torch.full((n,), float("inf"), device=dev),
                           s["sh_dist"] - RAY_EPS]),
                active=torch.cat([active, s["sh_do"]]))
            rec = HitRecord(t=rec2.t[:n], tri=rec2.tri[:n],
                            bary=rec2.bary[:n], hit=rec2.hit[:n],
                            inst=(rec2.inst[:n] if rec2.inst is not None
                                  else None))
            sh_clear = s["sh_do"] & ~rec2.hit[n:]
            L = L + torch.where(sh_clear[:, None], s["sh_ld"], 0.0)
        else:
            rec = trace_closest(o, d, RAY_EPS, float("inf"), active=active)
        stream = s["stream"]
        o_eff = o
        if alpha_on:
            # a hit on a cutout surface passes through stochastically
            # without consuming a bounce: trace again from the hit point,
            # at most ALPHA_HOPS times. Each hit is tested once: one that
            # fails its draw is settled (shades as opaque) and never drawn
            # for again
            settled = torch.zeros_like(rec.hit)
            for _ in range(ALPHA_HOPS):
                stream, u_a = stream.next_1d()
                cand = rec.hit & active & ~settled
                hd_l = interpolate_hit(geom, rec, o_eff, d,
                                       instances=flat.instances)
                pas = cand & (u_a >= _alpha_value(flat, hd_l.mat_idx,
                                                  hd_l.uv))
                settled = settled | (cand & ~pas)
                o_eff = torch.where(pas[:, None], hd_l.pos, o_eff)
                rec2 = trace_closest(o_eff, d, RAY_EPS, float("inf"),
                                     active=pas)
                rec = HitRecord(
                    t=torch.where(pas, rec2.t, rec.t),
                    tri=torch.where(pas, rec2.tri, rec.tri),
                    bary=torch.where(pas[:, None], rec2.bary, rec.bary),
                    hit=torch.where(pas, rec2.hit, rec.hit),
                    inst=(torch.where(pas, rec2.inst, rec.inst)
                          if rec.inst is not None else None))
        hit = rec.hit & active
        miss = active & ~rec.hit

        # environment + background on miss
        if env_on:
            env_le = lights_mod.env_radiance(env, d)
            if use_mis:
                env_pdf_full = lights_mod.env_pdf_of_dir(env, d) * p_inf
                w_env = torch.where(
                    s["prev_spec"], 1.0,
                    s["prev_pdf"] / torch.clamp(s["prev_pdf"] + env_pdf_full,
                                                min=1e-20))
            else:
                w_env = torch.ones((n,), device=dev)
            L = L + torch.where((miss & has_env)[:, None],
                                atten * env_le * w_env[:, None], 0.0)

        rays_new = s["rays"] + torch.sum(active.to(torch.float32)) * (
            2.0 if use_mis else 1.0)

        lane_state = dict(
            o=o, d=d, atten=atten, L=L, hit=hit, o_eff=o_eff,
            prev_pdf=s["prev_pdf"], prev_spec=s["prev_spec"],
            stream=stream, slot=s["slot"], bounce=bounce,
            rec_t=rec.t, rec_tri=rec.tri, rec_bary=rec.bary,
            **({"rec_inst": rec.inst} if rec.inst is not None else {}))

        if (settings.chunk_shade and not alpha_on
                and n > settings.chunk_shade
                and n % settings.chunk_shade == 0):
            upd = _chunked_shade(lane_state, _shade_lanes,
                                 settings.chunk_shade)
        else:
            upd = _shade_lanes(lane_state)

        # NEE occlusion: an any-hit wave right away, unless deferred onto
        # the next bounce's closest wave (fuse_shadow) or resolved by the
        # alpha loop in shading
        if (use_mis and (env_on or lights_on) and not fuse_shadow
                and not alpha_on):
            occ = trace_any(upd["sh_org"], upd["sh_dir"], RAY_EPS,
                            upd["sh_dist"] - RAY_EPS, active=upd["sh_do"])
            upd["L"] = upd["L"] + torch.where(
                (upd["sh_do"] & ~occ)[:, None], upd["sh_ld"], 0.0)

        out = dict(
            o=upd["o"], d=upd["d"], L=upd["L"], atten=upd["atten"],
            active=upd["active"], prev_pdf=upd["prev_pdf"],
            prev_spec=upd["prev_spec"], stream=upd["stream"],
            bounce=bounce + 1, rays=rays_new, slot=upd["slot"])
        if fuse_shadow:
            out.update({k: upd[k] for k in
                        ("sh_org", "sh_dir", "sh_dist", "sh_ld", "sh_do")})
        return out

    def _shade_lanes(ls):
        """Per-lane hit shading: interpolation, shading context, emission
        with MIS, BSDF sampling, NEE light sampling (the shadow ray leaves
        as sh_* state), Russian roulette, the next ray. A pure per-lane
        map: it runs at full width or on chunks of sorted lanes."""
        o, d, atten, L = ls["o"], ls["d"], ls["atten"], ls["L"]
        hit, stream, bounce = ls["hit"], ls["stream"], ls["bounce"]
        n = o.shape[0]
        dev = o.device
        rec = HitRecord(t=ls["rec_t"], tri=ls["rec_tri"], bary=ls["rec_bary"],
                        hit=hit, inst=ls.get("rec_inst"))

        # from the last alpha hop's origin (o itself without alpha)
        hd = interpolate_hit(geom, rec, ls["o_eff"], d,
                             instances=flat.instances)
        ctx = bsdf_mod.make_shading_context(
            mats, hd.mat_idx, hd.uv, flat.atlas, flat.atlas_table,
            slots=tex_slots)
        if normal_map:
            hd = _apply_normal_map(hd, flat, ctx.tex_rows, d)

        # emission on hit (MIS against NEE)
        le = bsdf_mod.emitted_radiance(ctx, hd.wo, luts, features=features)
        if use_mis and lights_on:
            cos_hit = torch.abs(torch.sum(d * hd.gnormal, dim=-1))
            # the distance from the previous path vertex, not from the
            # last alpha hop's origin: the pdf NEE would have used
            dist2_hit = torch.sum((hd.pos - o) ** 2, dim=-1)
            light_pdf_hit = (
                (1.0 - p_inf)
                * (ctx.emission[:, 1] * np.pi
                   / torch.clamp(lights.total_power, min=1e-20))
                * dist2_hit / torch.clamp(cos_hit, min=1e-20))
            w_emit = torch.where(
                ls["prev_spec"] | ~has_lights, 1.0,
                ls["prev_pdf"] / torch.clamp(ls["prev_pdf"] + light_pdf_hit,
                                             min=1e-20))
        else:
            w_emit = torch.ones((n,), device=dev)
        L = L + torch.where(hit[:, None], atten * le * w_emit[:, None], 0.0)

        # BSDF sampling
        stream, r2 = stream.next_2d()
        stream, r3 = stream.next_1d()
        stream, r4 = stream.next_1d()
        stream, rc = stream.next_2d()
        r4 = torch.cat([r2, r3[:, None], r4[:, None]], dim=-1)
        samp = bsdf_mod.sample(ctx, hd.wo, r4, rc, luts,
                               multiscatter=multiscatter, features=features,
                               mixture_pdf=settings.mixture_pdf)

        # next-event estimation: the shadow ray leaves as state; the
        # caller traces it
        sh_next = None
        if use_mis and (env_on or lights_on):
            stream, u_nee2 = stream.next_2d()
            stream, u_sel = stream.next_1d()
            if env_on and lights_on:
                use_env_light = (u_sel < p_inf) & has_env
                u_area = torch.where(
                    p_inf < 1.0,
                    (u_sel - p_inf) / torch.clamp(1.0 - p_inf, min=1e-20), 0.0)
                ls_env = lights_mod.sample_env_light(env, u_nee2)
                ls_area = lights_mod.sample_area_light(
                    geom, lights, hd.pos, u_area, u_nee2)
                sel = use_env_light[:, None]
                li = torch.where(sel, ls_env.li, ls_area.li)
                wi_world = torch.where(sel, ls_env.wi, ls_area.wi)
                dist = torch.where(use_env_light, ls_env.dist, ls_area.dist)
                l_pdf = torch.where(use_env_light, ls_env.pdf, ls_area.pdf)
                p_light = torch.where(use_env_light, p_inf,
                                      (1.0 - p_inf) * ls_area.p_light)
            elif env_on:
                lsmp = lights_mod.sample_env_light(env, u_nee2)
                li, wi_world, dist, l_pdf = lsmp.li, lsmp.wi, lsmp.dist, lsmp.pdf
                p_light = torch.ones((n,), device=dev)
            else:
                lsmp = lights_mod.sample_area_light(geom, lights, hd.pos,
                                                    u_sel, u_nee2)
                li, wi_world, dist, l_pdf = lsmp.li, lsmp.wi, lsmp.dist, lsmp.pdf
                p_light = lsmp.p_light

            wi_local = torch.stack(
                [torch.sum(wi_world * hd.frame_t, -1),
                 torch.sum(wi_world * hd.frame_b, -1),
                 torch.sum(wi_world * hd.normal, -1)], dim=-1)
            ev = bsdf_mod.evaluate(ctx, hd.wo, wi_local, luts,
                                   multiscatter=multiscatter,
                                   features=features)
            f_nonzero = torch.sum(ev.f * ev.f, dim=-1) > 0.0
            do_nee = hit & bsdf_mod.wants_nee(ctx) & f_nonzero
            if env_on and lights_on:
                do_nee = do_nee & (has_lights | has_env)
            ld = (li * ev.f * torch.abs(wi_local[..., 2:3])
                  / torch.clamp(p_light * l_pdf + ev.pdf, min=1e-20)[..., None])
            if alpha_on:
                # shadow segments run the alpha loop here: cutout surfaces
                # block stochastically, closest hit after closest hit
                occluded, stream = _alpha_shadow(
                    hd.pos, wi_world, dist - RAY_EPS, do_nee, stream)
                L = L + torch.where((do_nee & ~occluded)[:, None],
                                    atten * ld, 0.0)
            else:
                sh_next = dict(
                    sh_org=hd.pos, sh_dir=wi_world,
                    sh_dist=torch.where(do_nee, dist, 0.0),
                    sh_ld=torch.where(do_nee[:, None], atten * ld, 0.0),
                    sh_do=do_nee)
        if sh_next is None:
            sh_next = _empty_shadow(n, dev)

        # continue the path
        cont = (samp.flags & (bsdf_mod.SAMPLE_REFLECTED
                              | bsdf_mod.SAMPLE_TRANSMITTED)) != 0
        pdf_ok = samp.pdf > 0.0
        atten_new = atten * samp.f * torch.abs(samp.wi[..., 2:3]) / torch.clamp(
            samp.pdf, min=1e-20)[..., None]

        # Russian roulette after the first bounce (kernel.metal:655-663)
        stream, u_rr = stream.next_1d()
        q = torch.clamp(1.0 - torch.amax(atten_new, dim=-1), min=0.0)
        if bounce == 0:
            q = torch.zeros_like(q)
        killed = u_rr < q
        atten_new = atten_new / torch.clamp(1.0 - q, min=1e-20)[..., None]
        active_new = hit & cont & pdf_ok & ~killed

        wi_world_next = normalize(hd.frame_t * samp.wi[..., 0:1]
                                  + hd.frame_b * samp.wi[..., 1:2]
                                  + hd.normal * samp.wi[..., 2:3])

        return dict(
            o=torch.where(hit[:, None], hd.pos, o),
            d=torch.where(hit[:, None], wi_world_next, d),
            L=L,
            atten=torch.where(active_new[:, None], atten_new, atten),
            active=active_new,
            prev_pdf=torch.where(hit, samp.pdf, ls["prev_pdf"]),
            # weight-1 MIS for segments the light strategy cannot reach
            # (see the JAX integrator's comment at this line)
            prev_spec=torch.where(
                hit, ((samp.flags & (bsdf_mod.SAMPLE_SPECULAR
                                     | bsdf_mod.SAMPLE_TRANSMITTED)) != 0)
                | ((hd.wo[..., 2] <= -bsdf_mod.MIN_COS)
                   & (ctx.transmission > 0.0)),
                ls["prev_spec"]),
            stream=stream,
            slot=ls["slot"],
            **sh_next,
        )

    def _alpha_shadow(org, wi, rem, do_nee, stream):
        """(occluded, stream) of shadow segments through cutout surfaces
        (JAX integrator.py:427-452): up to ALPHA_HOPS + 1 closest-hit
        traces over each lane's remaining length `rem`, one draw per hop
        after its trace; a hit blocks with its opacity, else the segment
        goes on from it, and a lane still unresolved after the budget is
        occluded."""
        occluded = torch.zeros_like(do_nee)
        clear = torch.zeros_like(do_nee)
        for _ in range(ALPHA_HOPS + 1):
            qry = do_nee & ~occluded & ~clear
            srec = trace_closest(org, wi, RAY_EPS, rem, active=qry)
            shit = srec.hit & qry
            clear = clear | (qry & ~srec.hit)
            hd_s = interpolate_hit(geom, srec, org, wi,
                                   instances=flat.instances)
            a_s = _alpha_value(flat, hd_s.mat_idx, hd_s.uv)
            stream, u_s = stream.next_1d()
            blocked = shit & (u_s < a_s)
            occluded = occluded | blocked
            pas = shit & ~blocked
            org = torch.where(pas[:, None], hd_s.pos, org)
            rem = torch.where(pas, rem - srec.t, rem)
        return occluded | (do_nee & ~clear & ~occluded), stream

    def resolve_pending(s):
        """Settle the deferred shadow rays still pending (at the end of
        the loop, and before compaction drops lanes)."""
        if not fuse_shadow:
            return s
        occ = trace_any(s["sh_org"], s["sh_dir"], RAY_EPS,
                        s["sh_dist"] - RAY_EPS, active=s["sh_do"])
        s = dict(s)
        s["L"] = s["L"] + torch.where((s["sh_do"] & ~occ)[:, None],
                                      s["sh_ld"], 0.0)
        s.update(_empty_shadow(s["o"].shape[0], s["o"].device))
        return s

    body.resolve_pending = resolve_pending
    return body


def _apply_normal_map(hd, flat: FlatScene, tex_rows, d):
    """Tilt the shading frame by the normal map where the material binds
    one (JAX integrator.py:314-339): the tangent-space normal to world
    space, normalised as jnp.linalg.norm does (sqrt of the sum of squares,
    clamped at 1e-20), and a frame built from it alone."""
    has_nm, nm = sample_normal_map(flat.atlas, flat.atlas_table, tex_rows,
                                   hd.uv)
    mapped = (hd.frame_t * nm[..., 0:1] + hd.frame_b * nm[..., 1:2]
              + hd.normal * nm[..., 2:3])
    mapped = mapped / torch.clamp(norm(mapped, keepdim=True), min=1e-20)
    nt, nb, nn = from_normal(mapped)
    sel = has_nm[:, None]
    return dataclasses.replace(
        hd,
        normal=torch.where(sel, nn, hd.normal),
        wo=torch.where(sel, world_to_local((nt, nb, nn), -d), hd.wo),
        frame_t=torch.where(sel, nt, hd.frame_t),
        frame_b=torch.where(sel, nb, hd.frame_b))


def _put_lanes(dst, src, off: int, n: int):
    """Write a chunk's leaf `src` into rows [off, off + chunk) of the
    full-width leaf `dst` (in place for per-lane tensors); a leaf that is
    not per-lane (a stream's scalar dimension counter) takes the chunk's
    value, the same in every chunk."""
    if isinstance(dst, torch.Tensor):
        if dst.dim() >= 1 and dst.shape[0] == n:
            dst[off:off + src.shape[0]] = src
            return dst
        return src
    if dataclasses.is_dataclass(dst):
        return dataclasses.replace(dst, **{
            f.name: _put_lanes(getattr(dst, f.name), getattr(src, f.name),
                               off, n)
            for f in dataclasses.fields(dst)})
    return src


def _chunked_shade(ls, shade_fn, chunk: int):
    """Shade only the lanes that hit, in chunks of `chunk` lanes (the JAX
    `_chunked_shade`).

    Lanes are sorted hits first (stable), then ceil(hits / chunk) chunks
    go through `shade_fn`; the other lanes pass through untouched with
    active=False. Per-lane sampler streams are self-contained counters, so
    a permuted and chunked lane draws what it draws at full width; only
    dead lanes' streams go stale, and they never draw again. The JAX
    package runs the chunks in a `while_loop` of one compiled program;
    here they are a Python loop, each chunk a full pass of eager shading
    ops, at the price of one host sync for the hit count."""
    n = ls["o"].shape[0]
    dev = ls["o"].device
    key = torch.where(ls["hit"], 0, 1)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    srt = {k: _take_lanes(v, perm, n) for k, v in ls.items()}
    nch = -(-int(ls["hit"].sum()) // chunk)

    out = dict(
        o=srt["o"], d=srt["d"], L=srt["L"], atten=srt["atten"],
        active=torch.zeros((n,), dtype=torch.bool, device=dev),
        prev_pdf=srt["prev_pdf"], prev_spec=srt["prev_spec"],
        stream=srt["stream"], slot=srt["slot"], **_empty_shadow(n, dev))
    for i in range(nch):
        sel = slice(i * chunk, (i + 1) * chunk)
        cupd = shade_fn({k: _take_lanes(v, sel, n) for k, v in srt.items()})
        out = {k: _put_lanes(out[k], cupd[k], i * chunk, n) for k in out}
    return {k: _take_lanes(v, inv, n) for k, v in out.items()}


def _take_lanes(x, sel, n: int):
    """x[sel] for every per-lane tensor of a state leaf (streams are
    dataclasses of per-lane tensors and scalars); other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return x[sel] if x.dim() >= 1 and x.shape[0] == n else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _take_lanes(getattr(x, f.name), sel, n)
            for f in dataclasses.fields(x)})
    return x


def _compact_state(state, cap: int, sel_key):
    """Shrink the wavefront to `cap` lanes (the JAX `_compact_state`).

    Live lanes sort ahead of dead ones under a uniform random key drawn
    from `sel_key` (threefry, bitwise JAX's), and the first `cap` survive.
    The sort must be stable: a 2^18-lane draw has thousands of equal keys
    on u's 2^-23 grid, and jnp.argsort breaks those ties by lane index.
    When more than `cap` lanes are live, the survivors carry the
    Horvitz-Thompson weight live/cap on their throughput, which keeps the
    estimator unbiased. Banked radiance (state["L"], by state["slot"])
    must be scattered out by the caller first."""
    n = state["o"].shape[0]
    active = state["active"]
    dev = active.device
    live = torch.sum(active.to(torch.float32))
    u = threefry.uniform(sel_key, n, dev)
    sel = torch.argsort(torch.where(active, u, 2.0), stable=True)[:cap]
    w = torch.clamp(live / float(cap), min=1.0)
    new = {k: _take_lanes(v, sel, n) for k, v in state.items()}
    new["atten"] = new["atten"] * w
    new["L"] = torch.zeros((cap, 3), device=dev)
    return new


def _compaction_plan(n: int, settings: RenderSettings):
    """[(cap, bounce_limit)] segments (the JAX `_compaction_plan`): full
    width for two bounces, then halve every two bounces down to n/8 in
    multiples of 512 lanes; or settings.compact_plan (explicit or measured
    by render/autoplan.py) with caps scaled to this wave's share of the
    full wave, clamped to [512, n] and equal-cap segments merged."""
    if isinstance(settings.compact_plan, str):
        raise ValueError(
            "compact_plan='auto' must be resolved before rendering: call "
            "autoplan.resolve_auto_plan(flat, settings) (Renderer."
            "start_render and integrator.render do)")
    if settings.compact_plan is not None and not settings.compact:
        raise ValueError("compact_plan requires settings.compact=True")
    if not settings.compact or n < 8192 or settings.max_bounces <= 3:
        return [(n, settings.max_bounces)]
    if settings.compact_plan is not None:
        from platinum_tpu_torch.render import autoplan

        n_full = settings.num_pixels * max(1, settings.spp_batch)
        scale = n / n_full if n_full > n else 1.0

        def _cap(c):
            c = int(c)
            if scale < 1.0:
                c = -(-int(c * scale) // 512) * 512
            return min(max(c, 512), n)

        clamped = tuple((_cap(c), int(b)) for c, b in settings.compact_plan)
        autoplan.validate_plan(clamped, n, settings.max_bounces)
        merged = []
        for cap, b in clamped:
            if merged and merged[-1][0] == cap:
                merged[-1] = (cap, b)
            else:
                merged.append((cap, b))
        return merged
    plan = [(n, 2)]
    cap, b = n, 2
    while b < settings.max_bounces:
        cap = max((cap // 2 + 511) // 512 * 512, 512)
        nb = (min(b + 2, settings.max_bounces) if cap > 512
              else settings.max_bounces)
        plan.append((cap, nb))
        b = nb
        if cap == 512:
            break
    if plan[-1][1] < settings.max_bounces:
        plan.append((plan[-1][0], settings.max_bounces))
    return plan


def render_sample(flat: FlatScene, settings: RenderSettings, sample_idx,
                  pixel_ids=None, tracers=None, return_stats: bool = False,
                  features: frozenset = bsdf_mod.ALL_FEATURES):
    """Trace one sample per pixel; returns (R, 3) radiance, R the number
    of pixels or len(pixel_ids). With return_stats also the number of rays
    traced (closest + shadow). `pixel_ids` renders those pixels alone, in
    that order (a rank's shard on the multi-device path, parallel/); the
    sample batch is then 1, as in the JAX package. `tracers` overrides the
    (trace_closest, trace_any) pair, which is otherwise built for this
    call (the Renderer builds it once per start_render). With
    settings.compact the wave shrinks between the plan's segments; lane
    selection keys on PRNGKey(0) folded with the sample index, then with
    the segment index, as in the JAX package.

    With settings.spp_batch = B > 1, B samples of every pixel ride one
    wavefront: waves B times as wide and 1/B as many launches per spp.
    The per-lane sampler streams draw what B separate calls with sample
    indices sample_idx .. sample_idx + B - 1 draw, and the radiance
    returned is the per-pixel SUM of the B samples (callers divide by
    their spp count as usual)."""
    fused = _fuse_shadow_active(settings, features)
    dev = flat.camera.position.device
    batch = max(1, settings.spp_batch) if pixel_ids is None else 1
    if batch > 1:
        npx = settings.num_pixels
        lane_pixels = torch.arange(npx, device=dev).repeat(batch)
        lane_idx = int(sample_idx) + torch.arange(
            batch, device=dev).repeat_interleave(npx)
        state = init_path_state(flat, settings, lane_idx, lane_pixels,
                                with_shadow_state=fused)
        state["slot"] = lane_pixels.to(torch.int32)
    else:
        state = init_path_state(flat, settings, sample_idx, pixel_ids,
                                with_shadow_state=fused)
    body = make_bounce_body(flat, settings, features, tracers)
    n = state["o"].shape[0]
    plan = _compaction_plan(n, settings)
    out = None
    if len(plan) > 1 or batch > 1:
        # batched lanes bank into their pixels; otherwise lane i is row i
        # (len(pixel_ids) rows for a shard)
        out = torch.zeros((settings.num_pixels if batch > 1 else n, 3),
                          device=dev)
    if len(plan) > 1:
        base_key = threefry.fold_in(threefry.PRNGKey(0), int(sample_idx))
    for si, (cap, blimit) in enumerate(plan):
        if cap < state["o"].shape[0]:
            # pending deferred shadows must settle before lanes drop
            state = body.resolve_pending(state)
            out.index_add_(0, state["slot"], state["L"])
            state = _compact_state(state, cap,
                                   threefry.fold_in(base_key, si))
        while state["bounce"] < blimit and bool(state["active"].any()):
            state = body(state)
    state = body.resolve_pending(state)
    if out is None:
        out = state["L"]
    else:
        out.index_add_(0, state["slot"], state["L"])
    if return_stats:
        return out, state["rays"]
    return out


def bounce_step(flat: FlatScene, settings: RenderSettings, state,
                features: frozenset = bsdf_mod.ALL_FEATURES, tracers=None):
    """One bounce as its own call (render_sample_stepped's step): the JAX
    package's `bounce_step_jit` (integrator.py:781-786), which runs a
    bounce as one XLA program. Nothing is jitted here: every op of the
    port already runs as it is called. `tracers` as in render_sample."""
    return make_bounce_body(flat, settings, features, tracers)(state)


def render_sample_stepped(flat: FlatScene, settings: RenderSettings,
                          sample_idx,
                          features: frozenset = bsdf_mod.ALL_FEATURES,
                          return_stats: bool = False):
    """Host-driven bounce loop (JAX integrator.py:794-813): fuse_shadow
    off, camera rays and a fresh path state for every pixel, then one
    bounce_step a bounce up to max_bounces, stopping once no lane is
    active; no compaction and one sample per lane. Returns (H*W, 3)
    radiance, and with return_stats the rays traced. The tracer pair is
    built once for the sample."""
    if settings.fuse_shadow:
        settings = dataclasses.replace(settings, fuse_shadow=False)
    tracers = make_tracers(flat, settings)
    state = init_path_state(flat, settings, int(sample_idx))
    for _ in range(settings.max_bounces):
        state = bounce_step(flat, settings, state, features, tracers)
        if not bool(state["active"].any()):
            break
    if return_stats:
        return state["L"], state["rays"]
    return state["L"]


def render_step(flat: FlatScene, settings: RenderSettings,
                accum: torch.Tensor, accum_count: int,
                sample_seed: int | None = None,
                features: frozenset = bsdf_mod.ALL_FEATURES,
                tracers=None) -> torch.Tensor:
    """One progressive spp step: running mean into the (H*W, 3)
    accumulator. `sample_seed` (default accum_count) seeds the sampler."""
    if settings.spp_batch > 1:
        # render_sample would sum spp_batch samples while this step's
        # running mean assumes exactly one
        raise ValueError("render_step is a 1-spp step; use render_step_n "
                         "(or spp_batch=1) with sample-batched wavefronts")
    if sample_seed is None:
        sample_seed = accum_count
    radiance = render_sample(flat, settings, sample_seed, tracers=tracers,
                             features=features)
    k = float(accum_count)
    return (accum * k + radiance) / (k + 1.0)


def render_step_n(flat: FlatScene, settings: RenderSettings,
                  accum: torch.Tensor, accum_count: int, count: int,
                  features: frozenset = bsdf_mod.ALL_FEATURES,
                  tracers=None) -> torch.Tensor:
    """`count` progressive spp steps; the same running-mean formula as the
    JAX render_step_n (sum of the samples, then one blend). With
    settings.spp_batch = B every render_sample sums B samples, so the
    loop runs count / B times (count must be a multiple of B). `tracers`
    overrides the (trace_closest, trace_any) pair, as in render_sample."""
    batch = max(1, settings.spp_batch)
    if count % batch != 0:
        raise ValueError(f"count={count} not a multiple of "
                         f"spp_batch={batch}")
    total = torch.zeros((settings.num_pixels, 3), device=accum.device)
    for i in range(count // batch):
        total = total + render_sample(flat, settings,
                                      accum_count + i * batch,
                                      tracers=tracers, features=features)
    k = float(accum_count)
    return (accum * k + total) / (k + float(count))


def render(flat: FlatScene, settings: RenderSettings,
           features: frozenset = bsdf_mod.ALL_FEATURES,
           spp_per_call: int = 8) -> torch.Tensor:
    """Render settings.spp samples; (H, W, 3) linear working-space radiance.
    compact_plan="auto" is resolved here first (render/autoplan.py). The
    tracer pair is built once, for the probe and every sample."""
    tracers = make_tracers(flat, settings)
    if settings.compact_plan == "auto":
        from platinum_tpu_torch.render import autoplan

        settings = autoplan.resolve_auto_plan(flat, settings, tracers=tracers)
    accum = torch.zeros((settings.num_pixels, 3),
                        device=flat.camera.position.device)
    done = 0
    while done < settings.spp:
        n = min(spp_per_call, settings.spp - done)
        accum = render_step_n(flat, settings, accum, done, n,
                              features=features, tracers=tracers)
        done += n
    return accum.reshape(settings.height, settings.width, 3)
