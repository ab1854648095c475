"""Time the port's render paths on the GPU, step by step, optionally under
torch.profiler.

    python3 tools/torch_time_paths.py --config headline_compact --spp 8
    python3 tools/torch_time_paths.py --config bistro --profile
    python3 tools/torch_time_paths.py --root OTHER_CHECKOUT --config headline

Configs (bench.py's, at 512x512, 8 bounces, mis, halton, the packet
tracer, unless they say otherwise): `headline` = sponza_class_512 without
compaction, `headline_compact` = sponza_class_512 (compact=True,
compact_plan="auto"), `instanced` = sponza_instanced_512 (instancing="on",
compact=True), `mt3_knob` = sponza_class_512_mt3_knob (headline_compact
with mt_precision="high", K4), `two_phase` and `oct_order` =
headline_compact with mt_precision="two_phase" (K5) or oct_order=True
(K7), `bistro` = bistro_class_studio (the colonnade at 24x12, 1.08M
triangles, 960x540, 4 bounces, compact=True with the static plan,
stream="auto": streamed blocks, K6), `fuse_shadow`, `spp_batch2` and
`chunk_shade` = headline_compact with fuse_shadow=True, spp_batch=2 (each
step renders two samples; times and launches are per spp) or
chunk_shade=65536, `raystream` = headline_compact traced by the
breadth-first ray-stream pair (K15) as `tracers=`, `pipe` =
headline_compact traced by the packet tracer with the pipelined walk
(K9, make_packet_tracer(pipe=True)) as `tracers=`, each stepped through
integrator.render_step_n, `bf` = headline_compact with tracer="bf" (the
breadth-first pipeline, K10-K14, for closest hit). `--root` imports platinum_tpu_torch
from another checkout, so two versions can be timed in turns within one
call on one card; a checkout whose port has no scenes module of its own
takes the colonnade from that checkout's JAX package scenes module (numpy
only). Prints one JSON line per run: the card and its power limit, the
per-step wall times (host clock around work that ends in a device
synchronise; the first step pays first-use set-up), the rays per spp (the
integrator's own count) and, with --profile, one more spp under
torch.profiler: device kernel time, busy share, kernel launches and the
trace kernels' device time by mode. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HEADLINE = dict(compact=True, compact_plan="auto", instancing="off")
CONFIGS = {
    "headline": dict(compact=False, instancing="off"),
    "headline_compact": HEADLINE,
    "instanced": dict(compact=True, instancing="on"),
    "mt3_knob": dict(HEADLINE, mt_precision="high"),
    "two_phase": dict(HEADLINE, mt_precision="two_phase"),
    "oct_order": dict(HEADLINE, oct_order=True),
    "bistro": dict(width=960, height=540, max_bounces=4, compact=True,
                   instancing="off", stream="auto"),
    "fuse_shadow": dict(HEADLINE, fuse_shadow=True),
    "spp_batch2": dict(HEADLINE, spp_batch=2),
    "chunk_shade": dict(HEADLINE, chunk_shade=65536),
    "raystream": HEADLINE,
    "pipe": HEADLINE,
    "bf": dict(HEADLINE, tracer="bf"),
}
# the configs traced by a tracer pair of their own (`tracers=`)
TRACERS = ("raystream", "pipe")
SCENES = {"bistro": dict(columns=24, rows=12)}   # make_colonnade_scene's


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--config", choices=sorted(CONFIGS), default="headline")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import platinum_tpu_torch
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
    from platinum_tpu_torch.render.types import RenderSettings

    if not platinum_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {platinum_tpu_torch.__file__}, "
                         f"not the port under {root}")
    own = os.path.join(root, "platinum_tpu_torch", "app", "scenes.py")
    scenes = importlib.import_module(
        "platinum_tpu_torch.app.scenes" if os.path.exists(own)
        else "platinum_tpu.app.scenes")
    scene, cam = scenes.make_colonnade_scene(**SCENES.get(args.config, {}))
    kw = dict(width=512, height=512, max_bounces=8, kernel="mis",
              sampler="halton", tracer="packet")
    kw.update(CONFIGS[args.config])
    settings = RenderSettings(spp=args.spp, **kw)
    r = Renderer(scene, device="cuda")
    r.start_render(cam, settings)
    s = r.settings
    feats = analyze_features(r.flat)
    batch = max(1, getattr(s, "spp_batch", 1))
    tracers = None
    steps = []
    if args.config in TRACERS:
        from platinum_tpu_torch.ops.packet_trace import make_packet_tracer
        from platinum_tpu_torch.ops.raystream import make_stream_tracer

        f = r.flat
        tree = (f.wbvh_nodes, f.wbvh_tris, f.wbvh_meta, f.wbvh_slot)
        tracers = (make_stream_tracer(*tree) if args.config == "raystream"
                   else make_packet_tracer(*tree, pipe=True))
        accum = torch.zeros((s.num_pixels, 3), device="cuda")
        for i in range(s.spp):
            t0 = time.perf_counter()
            accum = integrator.render_step_n(f, s, accum, i, 1,
                                             features=feats, tracers=tracers)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
    while tracers is None and not r.status & RenderStatus.DONE:
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3 / batch)
    stats = dict(return_stats=True, features=feats)
    if tracers is not None:
        stats["tracers"] = tracers
    rays = float(integrator.render_sample(r.flat, s, 0, **stats)[1]) / batch
    out = dict(
        card=subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        root=args.root, config=args.config, steps_ms=steps,
        ms_per_spp=sum(steps[1:]) / max(1, len(steps) - 1),
        rays_per_spp=rays,
        # a port from before compaction has no plan: one full-width segment
        plan=[list(x) for x in getattr(
            integrator, "_compaction_plan",
            lambda n, st: [(n, st.max_bounces)])(s.num_pixels, s)])
    out["mrays_per_s"] = rays / out["ms_per_spp"] / 1e3
    if args.profile:
        out.update(_profile(integrator, r, s, feats, tracers, batch))
    print(json.dumps(out), flush=True)


def _profile(integrator, r, s, feats, tracers, batch):
    """One render_sample call under torch.profiler; wall time, device
    time and launches are per sample (the call renders `batch` of them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(features=feats)
    if tracers is not None:
        kw["tracers"] = tracers
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        integrator.render_sample(r.flat, s, batch, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / batch
    device_us, trace_us, launches = 0.0, {}, 0
    for ev in prof.key_averages():
        if ev.key == "cudaLaunchKernel":
            launches += ev.count
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        device_us += dt
        if any(k in ev.key for k in ("wide_trace", "stream_mt", "bf_")):
            trace_us[ev.key[:160]] = [dt / 1e3 / batch, ev.count / batch]
    device_ms = device_us / 1e3 / batch
    return dict(profiled_wall_ms=wall, device_kernel_ms=device_ms,
                device_busy=device_ms / wall,
                kernel_launches=launches / batch,
                trace_kernels_ms_count=trace_us)


if __name__ == "__main__":
    main()
