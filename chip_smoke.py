"""Drive the PyTorch/CUDA port (platinum_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, one printed line each (any failure exits non-zero):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit
  2. build: compiles the wide-BVH kernel (csrc/wide_trace.cu) from the
     checkout
  3. kernel vs plain: the kernel's closest-hit and any-hit modes against
     the plain PyTorch version on the full colonnade (271k triangles), on
     16,384 rays each of a camera wave, a bounce-like wave from surface
     points and a wave of shadow segments to light points; then the time
     of each whole 262,144-ray wave
  4. main path: Renderer(scene).start_render(...) at 512x512, 4 spp,
     8 bounces, mis, halton, the packet tracer; render() until done,
     readback(), EXR export; both kernel modes must have launched
  5. the kernel path against the plain path end to end: the full
     colonnade at 64x64, 1 spp, rendered with the default tracers and with
     the plain tracer pair passed to render_sample
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_RTOL, T_ATOL = 1e-4, 1e-5        # t bars (tests/test_pallas_trace.py)
TIE_RTOL, TIE_ATOL = 1e-5, 1e-6    # t within this = a tie: ids may differ
AGREE = 0.995                      # hit-set / occlusion agreement
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3    # per-pixel bar (tests/test_torch_slice.py)
MEAN_RTOL = 1e-3
N_CMP = 16_384                     # rays per compared wave
N_WAVE = 512 * 512                 # rays per main-path wave
SEED = 20261016


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device (this script needs a GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    return torch.device("cuda", 0), smi


def phase_build():
    from platinum_tpu_torch.ops import packet_trace as pt

    t0 = time.perf_counter()
    path = pt.build_kernel()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path)}", flush=True)


def _rays(o, d, tmin, tmax):
    r = o.shape[0]
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        tmin.expand(r), tmax.expand(r)]).contiguous()


def _waves(flat, nodes, dev):
    """Camera, bounce-like and shadow waves of N_WAVE rays each, made from
    a numpy seed, in the order the packet tracer hands them to the kernel
    (camera rays in pixel order, the others octant + Morton sorted)."""
    from platinum_tpu_torch.ops.packet_trace import _ray_sort_key, sort_frame
    from platinum_tpu_torch.render.integrator import RAY_EPS, init_path_state
    from platinum_tpu_torch.render.types import RenderSettings

    rng = np.random.default_rng(SEED)
    eps = torch.tensor(RAY_EPS, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    st = init_path_state(flat, RenderSettings(width=512, height=512,
                                              sampler="halton"), 0)
    camera = _rays(st["o"], st["d"], eps, inf)

    def surface_points(table, n):
        rows = table[torch.from_numpy(rng.integers(0, table.shape[0], n))
                     .to(dev)]
        b = torch.from_numpy(rng.random((n, 2), np.float32)).to(dev)
        b = torch.where(b.sum(-1, keepdim=True) > 1.0, 1.0 - b, b)
        return rows[:, 0:3] + rows[:, 3:6] * b[:, 0:1] + rows[:, 6:9] * b[:, 1:2]

    p = surface_points(flat.geometry.tri_geo, N_WAVE)
    d = torch.from_numpy(rng.normal(size=(N_WAVE, 3)).astype(np.float32)).to(dev)
    d = d / d.norm(dim=-1, keepdim=True)
    seg = surface_points(flat.lights.packed, N_WAVE) - p
    dist = seg.norm(dim=-1)
    seg = seg / dist[:, None]

    lo, inv_extent = sort_frame(nodes)
    order = torch.argsort(_ray_sort_key(p, d, lo, inv_extent), stable=True)
    bounce = _rays(p[order], d[order], eps, inf)
    order = torch.argsort(_ray_sort_key(p, seg, lo, inv_extent), stable=True)
    shadow = _rays(p[order], seg[order], eps, (dist - RAY_EPS)[order])
    sample = torch.from_numpy(rng.choice(N_WAVE, N_CMP, replace=False)).to(dev)
    return camera, bounce, shadow, sample


def _borderline(ray, tri64, eps=5e-4, t_rel=1e-5):
    """True when, in float64, the ray grazes some triangle within eps of
    its valid region (a barycentric edge, an end of (tmin, tmax), or a
    near-zero determinant), so an fp32 accept/reject may go either way:
    tests/test_pallas_trace.py's `_assert_borderline` criterion, with the
    t end tightened from 5e-4 to 1e-5 relative (a shadow segment ends
    RAY_EPS short of its light, which the looser bar would count)."""
    o, d, tmin, tmax = ray[0:3], ray[3:6], ray[6], ray[7]
    v0, e1, e2 = tri64[:, 0:3], tri64[:, 3:6], tri64[:, 6:9]
    pv = np.cross(d[None, :], e2)
    det = (e1 * pv).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(det != 0.0, 1.0 / np.where(det == 0.0, 1.0, det), np.inf)
        sv = o[None, :] - v0
        u = (sv * pv).sum(-1) * inv
        qv = np.cross(sv, e1)
        v = (d[None, :] * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        w = 1.0 - u - v
        near = ((u > -eps) & (v > -eps) & (w > -eps) & np.isfinite(t)
                & (t > tmin * (1 - t_rel)) & (t < tmax * (1 + t_rel)))
        t_border = np.abs(t - tmin)
        if np.isfinite(tmax):
            t_border = np.minimum(t_border, np.abs(t - tmax))
        border = ((np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(w)) < eps)
                  | (t_border < t_rel * np.maximum(np.abs(t), 1.0))
                  | (np.abs(det) < 1e-6 * (np.abs(det).max() + 1e-30)))
    return bool((near & border).any())


def _compare(name, k, p, any_hit, rays=None, tri64=None):
    """Hold kernel outputs k to plain outputs p; returns max |t_k - t_p|
    over common hits (closest) or max |occluded_k - occluded_p| (any).

    Without `rays`, the bars of the compared subsets: hit sets agree on
    >= 99.5% of rays, ids equal outside t ties, t to rtol/atol. With
    `rays` and `tri64` (whole waves): a ray agrees when its hit status
    agrees and, hitting, its id does or its t ties; >= 99.5% must agree,
    every ray that does not must be certified borderline in float64
    (`_borderline`), and t holds to rtol/atol wherever the ids agree."""
    hk, hp = k[1] >= 0, p[1] >= 0
    both = hk & hp
    same = k[1] == p[1]
    tie = torch.isclose(k[0], p[0], rtol=TIE_RTOL, atol=TIE_ATOL)
    bad = hk != hp
    if rays is None:
        check(bool((same | tie)[both].all()),
              f"{name}: {int((both & ~same & ~tie).sum())} rays hit another "
              f"triangle outside a t tie")
    elif not any_hit:
        bad = bad | (both & ~same & ~tie)
    agree = 1.0 - bad.float().mean().item()
    check(agree >= AGREE, f"{name}: {agree:.4%} of rays agree < {AGREE:.1%}")
    if rays is not None:
        host = rays.double().cpu().numpy()
        idx = torch.nonzero(bad).squeeze(1).cpu().numpy()
        uncertified = [int(i) for i in idx if not _borderline(host[:, i], tri64)]
        check(not uncertified, f"{name}: rays {uncertified[:8]} disagree "
                               f"without a borderline triangle")
    if any_hit:
        print(f"  {name}: occlusion agrees on {agree:.4%} "
              f"({int(hp.sum())} occluded, {int(bad.sum())} disagreeing"
              f"{', all certified borderline' if rays is not None else ''})",
              flush=True)
        return float((hk != hp).any())
    common = both & same
    tk, tp = k[0][common], p[0][common]
    t_ok = torch.isclose(tk, tp, rtol=T_RTOL, atol=T_ATOL)
    check(bool(t_ok.all()), f"{name}: t differs beyond rtol={T_RTOL} "
                            f"atol={T_ATOL} on {int((~t_ok).sum())} rays")
    err = float((tk - tp).abs().max()) if common.any() else 0.0
    print(f"  {name}: {agree:.4%} of rays agree, {int(both.sum())} common "
          f"hits, {int((both & ~same & tie).sum())} id differences in t "
          f"ties, {int(bad.sum())} disagreeing"
          f"{' (all certified borderline)' if rays is not None else ''}, "
          f"max |dt| {err:.3e}", flush=True)
    return err


def _time_ms(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel_vs_plain(scene, cam, dev):
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    t0 = time.perf_counter()
    flat = flatten_scene(scene, cam, RenderSettings(
        width=512, height=512, tracer="packet", instancing="off"), device=dev)
    print(f"kernel vs plain: colonnade flattened in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{flat.geometry.indices.shape[0]} triangles, "
          f"{flat.wbvh_nodes.shape[0]} wide nodes, "
          f"{flat.wbvh_tris.shape[0]} MT blocks, "
          f"{int(flat.lights.count)} lights", flush=True)
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    camera, bounce, shadow, sample = _waves(flat, nodes, dev)
    tri64 = flat.geometry.tri_geo[:, 0:9].double().cpu().numpy()

    errs = {"closest": 0.0, "any": 0.0}
    for name, wave, any_hit in (("camera closest", camera, False),
                                ("bounce closest", bounce, False),
                                ("shadow any", shadow, True)):
        sub = wave[:, sample].contiguous()
        k = pt.trace_wide(sub, nodes, blocks, meta, any_hit)
        torch.cuda.synchronize()
        p = pt.trace_wide_plain(sub, nodes, blocks, meta, any_hit)
        torch.cuda.synchronize()
        mode = "any" if any_hit else "closest"
        errs[mode] = max(errs[mode], _compare(name, k, p, any_hit))

    # whole 262,144-ray waves, the shape the main path hands the kernel:
    # timed, and held to the certified bars (at this count a few rays
    # graze an edge or leave their surface at t ~ tmin, where one fp32
    # summation order accepts a triangle the other rejects)
    times = {}
    for name, wave, any_hit in (("camera closest", camera, False),
                                ("bounce closest", bounce, False),
                                ("shadow any", shadow, True)):
        out = {}

        def kernel():
            out["k"] = pt.trace_wide(wave, nodes, blocks, meta, any_hit)

        def plain():
            out["p"] = pt.trace_wide_plain(wave, nodes, blocks, meta, any_hit)

        kms = _time_ms(kernel, 20)
        pms = _time_ms(plain, 1, warm=False)
        mode = "any" if any_hit else "closest"
        errs[mode] = max(errs[mode], _compare(
            f"{name} (whole wave)", out["k"], out["p"], any_hit, wave, tri64))
        times[name] = (kms, pms)
        print(f"  time per {wave.shape[1]}-ray wave, {name}: kernel "
              f"{kms:.3f} ms, plain {pms:.1f} ms", flush=True)
    return errs, times


def phase_main_path(scene, cam, dev):
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.integrator import render_sample
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(width=512, height=512, spp=4, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", instancing="off")
    renderer = Renderer(scene, device=dev)
    renderer.start_render(cam, settings)
    for mode in pt.LAUNCHES:
        pt.LAUNCHES[mode] = 0
    steps = []
    while not renderer.status & RenderStatus.DONE:
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    img = renderer.readback()
    launches = dict(pt.LAUNCHES)
    check(img.shape == (512, 512, 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image has non-finite values")
    check(float(img.mean()) > 0.0, f"image mean {img.mean()} is not > 0")
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not launch both kernel modes: {launches}")

    feats = analyze_features(renderer.flat)
    rays = 0.0
    for i in range(settings.spp):
        rays += float(render_sample(renderer.flat, settings, i,
                                    return_stats=True, features=feats)[1])
    # steady state: the first step also pays first-use set-up
    ms_spp = float(np.mean(steps[1:])) * 1e3
    rays_spp = rays / settings.spp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "colonnade.exr")
        renderer.export_exr(path)
        exr_bytes = os.path.getsize(path)
    check(exr_bytes > 0, "empty EXR")
    print(f"main path: 512x512 x {settings.spp} spp x {settings.max_bounces} "
          f"bounces: {ms_spp:.1f} ms/spp after the first step "
          f"({steps[0] * 1e3:.1f} ms), {rays_spp / ms_spp / 1e3:.2f} Mrays/s "
          f"({rays_spp:.0f} rays/spp), mean {img.mean():.4f}, "
          f"launches {launches}, EXR {exr_bytes} bytes", flush=True)
    return launches, ms_spp


def phase_end_to_end(scene, cam, dev):
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
    from platinum_tpu_torch.render.integrator import render_sample
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(width=64, height=64, spp=1, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", instancing="off")
    flat = flatten_scene(scene, cam, settings, device=dev)
    feats = analyze_features(flat)
    plain = pt.make_packet_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                                  flat.wbvh_meta, flat.wbvh_slot,
                                  trace_fn=pt.trace_wide_plain)
    img_k = render_sample(flat, settings, 0, features=feats).cpu().numpy()
    img_p = render_sample(flat, settings, 0, tracers=plain,
                          features=feats).cpu().numpy()
    close = np.isclose(img_k, img_p, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img_k.mean() / img_p.mean() - 1.0)
    print(f"end to end 64x64x1: {close.mean():.4%} of pixels within "
          f"rtol={PIX_RTOL} atol={PIX_ATOL} ({int((~close).sum())} outside), "
          f"mean {img_k.mean():.5f} vs {img_p.mean():.5f} "
          f"(rel {rel:.2e})", flush=True)
    check(bool(np.isfinite(img_k).all()), "kernel render not finite")
    check(close.mean() >= AGREE, "kernel and plain renders differ per pixel")
    check(rel <= MEAN_RTOL, "kernel and plain render means differ")


def main():
    dev, _ = phase_device()
    phase_build()
    from platinum_tpu.app.scenes import make_colonnade_scene

    scene, cam = make_colonnade_scene()
    errs, times = phase_kernel_vs_plain(scene, cam, dev)
    launches, _ = phase_main_path(scene, cam, dev)
    phase_end_to_end(scene, cam, dev)

    src = "platinum_tpu_torch/csrc/wide_trace.cu"
    kernels = [
        {"name": "wide_trace closest (K1)", "route": "cuda", "source": src,
         "replaces": "platinum_tpu/ops/pallas_trace.py:99",
         "launches": launches["closest"], "max_abs_err": errs["closest"],
         "ms": times["bounce closest"][0],
         "plain_ms": times["bounce closest"][1]},
        {"name": "wide_trace any-hit (K2)", "route": "cuda", "source": src,
         "replaces": "platinum_tpu/ops/pallas_trace.py:399",
         "launches": launches["any"], "max_abs_err": errs["any"],
         "ms": times["shadow any"][0], "plain_ms": times["shadow any"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
