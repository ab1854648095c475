"""Time the breadth-first tracers' level kernels on the GPU, level by level:
K15 (the ray-stream tracer's leaf-pair kernel, `raystream.stream_mt`) on
each leaf level's recorded (ray, block) pairs, and K11 (the breadth-first
pipeline's level prefix, `bfstream.bf_prefix`) on each level's recorded
inputs, on the headline colonnade's (271k triangles, 512x512) camera and
bounce waves as closest hit and shadow wave as any hit, the waves
chip_smoke.py builds.

    python3 tools/torch_time_levels.py [--root OTHER_CHECKOUT] [--reps N]

K15 runs at "highest" on the pairs its tracer recorded and at "high" and
"default" on the same pairs, and, where the checkout has it, its
one-thread-per-pair reference (`per_pair=True`) beside it; K11 on each
level's recorded inputs, writing into buffers of the level's capacities.
Each time is device time: CUDA events around --reps calls queued behind
a sleep on the stream (`device_ms`), so that the host's launch overhead
does not count, per level and summed over the wave's levels. `--root`
imports platinum_tpu_torch and chip_smoke.py (`_wave_points`, `_waves`,
`JOBS`, `_time_ms`) from another checkout, so that two versions can be
timed in turns within one call on one card (parent, change, change,
parent: four processes). Prints one JSON line: the card and its power
limit, the checkout, and per wave and kernel the ms per wave, per level
and the launches; K15's pairs and distinct blocks per level. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def device_ms(torch, fn, reps):
    """Device ms of one call of `fn`: CUDA events around `reps` calls
    queued behind a sleep on the stream, so that the host's time to launch
    them (Python, argument checks, allocation: tens of microseconds a
    call, more than a small level's kernel) does not count; raises where
    the queue ran dry before the last launch was queued."""
    import time

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    sleep_s = 4.0 * reps * host_s + 2e-3
    torch.cuda._sleep(int(sleep_s * 2.0e9))     # cycles at <= 2 GHz
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s > sleep_s:
        raise RuntimeError(f"queued {reps} calls in {queued_s:.4f} s, the "
                           f"sleep may not have covered them")
    return start.elapsed_time(stop) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    import platinum_tpu_torch
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.ops import bfstream as bf
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.ops import raystream as rs
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    for mod in (cs, platinum_tpu_torch):
        if not mod.__file__.startswith(root):
            raise SystemExit(f"imported {mod.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    pt.build_kernels()
    out = dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), root=args.root, ms={}, launches={},
        levels={}, pairs={}, blocks={})
    scene, cam = make_colonnade_scene()
    flat = flatten_scene(scene, cam, RenderSettings(
        width=512, height=512, tracer="packet", instancing="off"),
        device=dev)
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    waves = cs._waves(cs._wave_points(flat, dev), nodes, dev)
    per_pair = "per_pair" in inspect.signature(rs.stream_mt).parameters

    def timed(fn):
        return device_ms(torch, fn, args.reps)

    tc, ta = bf.make_bf_tracer(flat.wbvh_nodes, blocks, meta)
    for name, wave, any_hit in cs.JOBS:
        rays = waves[wave]
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        # K15 on each leaf level's pairs, as the ray-stream tracer made them
        levels = []

        def record(*a):
            levels.append(a[:4])
            return rs.stream_mt(*a)

        pair = rs.make_stream_tracer(flat.wbvh_nodes, blocks, meta,
                                     mt_fn=record)
        pair[int(any_hit)](o, d, rays[6], rays[7])
        kinds = [(tier, {}) for tier in ("highest", "high", "default")]
        if per_pair:
            kinds += [(f"{tier}+per_pair", dict(per_pair=True))
                      for tier in ("highest", "high", "default")]
        for kind, kw in kinds:
            tier = kind.split("+")[0]
            per_level = [timed(lambda lv=lv: rs.stream_mt(
                *lv, blocks, any_hit, tier, **kw)) for lv in levels]
            out["ms"][f"{name} K15 {kind}"] = sum(per_level)
            out["levels"][f"{name} K15 {kind}"] = per_level
        out["launches"][f"{name} K15"] = len(levels)
        out["pairs"][f"{name} K15"] = [int(lv[2].shape[0]) for lv in levels]
        out["blocks"][f"{name} K15"] = [
            int(torch.unique(lv[3]).numel()) for lv in levels]
        # K11 on each level's recorded inputs
        _, segs = (ta if any_hit else tc).with_levels(o, d, rays[6], rays[7])
        seg = segs[0]
        stat = seg["stat"].to(dev)
        mt_cap = seg["levels"][-1]["mt_units"].shape[0]
        per_level = []
        for lvl, lv in enumerate(seg["levels"][:-1]):
            bufs = [torch.empty(max(lv["cap_next"], 1) * 128,
                                dtype=torch.int32, device=dev),
                    torch.empty(mt_cap * 128, dtype=torch.int32, device=dev),
                    torch.empty(mt_cap, dtype=torch.int32, device=dev),
                    torch.zeros(8, dtype=torch.int32, device=dev)]
            per_level.append(timed(
                lambda lv=lv, lvl=lvl, bufs=bufs: bf.bf_prefix(
                    lv["units"], stat[lvl], lv["counts"], meta,
                    lv["cap_next"], mt_cap, *bufs)))
        out["ms"][f"{name} K11"] = sum(per_level)
        out["levels"][f"{name} K11"] = per_level
        out["launches"][f"{name} K11"] = len(seg["levels"]) - 1
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
