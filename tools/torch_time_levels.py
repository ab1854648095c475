"""Time the breadth-first tracers' level kernels on the GPU, level by level:
K15 (the ray-stream tracer's leaf-pair kernel, `raystream.stream_mt`) on
each leaf level's recorded (ray, block) pairs, and K10, K11, K12, K13 and
K14 (the breadth-first pipeline's expand `bf_expand`, level prefix
`bf_prefix`, emit `bf_emit`, MT kernel `bf_mt` and backward fold
`bf_bwd`) on each level's recorded inputs, on the headline
colonnade's (271k triangles, 512x512) camera and bounce waves as closest
hit and shadow wave as any hit, the waves chip_smoke.py builds.

    python3 tools/torch_time_levels.py [--root OTHER_CHECKOUT] [--reps N]
        [--kernels K15,K10,K11,K12,K13,K14]

K15 runs at "highest" on the pairs its tracer recorded and at "high" and
"default" on the same pairs; K10 on each level's recorded inputs and K12
on each level's recorded inputs and regions, writing into lists of the
level's capacities; K11 on each level's recorded inputs, writing into
buffers of the level's capacities; K13 at every tier on the whole
recorded MT list (the tracer's one launch a wave) and on each level's
slice of it (the tiles between two MT cursors), and K14 on each level's
recorded inputs (deepest first, each level's children the results of the
level below).
Each time is device time: CUDA events around --reps calls queued behind
a sleep on the stream (`device_ms`), so that the host's launch overhead
does not count, per level and summed over the wave's levels. `--root`
imports platinum_tpu_torch and chip_smoke.py (`_wave_points`, `_waves`,
`JOBS`, `_time_ms`) from another checkout, so that two versions can be
timed in turns within one call on one card (parent, change, change,
parent: four processes). Prints one JSON line: the card and its power
limit, the checkout, and per wave and kernel the ms per wave, per level
and the launches; K15's pairs and distinct blocks per level; K13's MT
tiles per level. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TIERS = ("highest", "high", "default")


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
    ap.add_argument("--kernels", default="K15,K10,K11,K12,K13,K14",
                    help="the kernels to time, comma-separated")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
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

    def timed(fn):
        return device_ms(torch, fn, args.reps)

    def k15_levels(name, any_hit, o, d, rays):
        """K15 on each leaf level's pairs, as the ray-stream tracer made
        them."""
        levels = []

        def record(*a):
            levels.append(a[:4])
            return rs.stream_mt(*a)

        pair = rs.make_stream_tracer(flat.wbvh_nodes, blocks, meta,
                                     mt_fn=record)
        pair[int(any_hit)](o, d, rays[6], rays[7])
        for tier in TIERS:
            per_level = [timed(lambda lv=lv: rs.stream_mt(
                *lv, blocks, any_hit, tier)) for lv in levels]
            out["ms"][f"{name} K15 {tier}"] = sum(per_level)
            out["levels"][f"{name} K15 {tier}"] = per_level
        out["launches"][f"{name} K15"] = len(levels)
        out["pairs"][f"{name} K15"] = [int(lv[2].shape[0]) for lv in levels]
        out["blocks"][f"{name} K15"] = [
            int(torch.unique(lv[3]).numel()) for lv in levels]

    def k10_k12_levels(name, seg, stat, which):
        """K10 (`which` "K10") or K12 ("K12") on each level's recorded
        inputs."""
        mt_cap = seg["levels"][-1]["mt_units"].shape[0]
        per_level = []
        for lvl, lv in enumerate(seg["levels"][:-1]):
            if which == "K10":
                fn = (lambda lv=lv, lvl=lvl: bf.bf_expand(
                    lv["units"], stat[lvl], lv["pairs"], seg["rays"], nodes))
            else:
                lists = (torch.empty(max(lv["cap_next"], 1) * 128,
                                     dtype=torch.int32, device=dev),
                         torch.empty(mt_cap * 128, dtype=torch.int32,
                                     device=dev))
                fn = (lambda lv=lv, lvl=lvl, lists=lists: bf.bf_emit(
                    lv["pairs"], lv["masks"], stat[lvl], lv["dn"],
                    lv["uoff"], lv["base"], *lists))
            per_level.append(timed(fn))
        out["ms"][f"{name} {which}"] = sum(per_level)
        out["levels"][f"{name} {which}"] = per_level
        out["launches"][f"{name} {which}"] = len(seg["levels"]) - 1
        out["pairs"][f"{name} units"] = [
            int(r[0]) for r in seg["stat"].tolist()[:-1]]

    def k11_levels(name, seg, stat):
        """K11 on each level's recorded inputs."""
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

    def k13_levels(name, any_hit, seg, stat):
        """K13 on the whole MT list and on each level's slice of it."""
        mtr, rows = seg["levels"][-1], seg["stat"].tolist()
        cuts = [(rows[lvl][1], rows[lvl + 1][1])
                for lvl in range(len(rows) - 1)]
        # each level's tiles copied out (the wrappers take 16-byte
        # aligned tensors)
        slices = [(mtr["mt_pairs"][a * 128:b * 128].clone(),
                   mtr["mt_units"][a:b].clone()) for a, b in cuts]
        for tier in TIERS:
            out["ms"][f"{name} K13 {tier}"] = timed(lambda: bf.bf_mt(
                mtr["mt_pairs"], mtr["mt_units"], stat[-1], seg["rays"],
                blocks, any_hit, tier))
            per_level = []
            for (a, b), (pairs, units) in zip(cuts, slices):
                row = torch.zeros(8, dtype=torch.int32, device=dev)
                row[1] = b - a
                per_level.append(timed(
                    lambda pairs=pairs, units=units, row=row: bf.bf_mt(
                        pairs, units, row, seg["rays"], blocks, any_hit,
                        tier)) if b > a else 0.0)
            out["levels"][f"{name} K13 {tier}"] = per_level
        out["launches"][f"{name} K13"] = 1
        out["pairs"][f"{name} K13 tiles"] = [b - a for a, b in cuts]

    def k14_levels(name, seg, stat):
        """K14 on each level's recorded inputs, deepest first; the lists
        are shallowest first."""
        levels = seg["levels"]
        mt = levels[-1]["mt"]
        per_level = []
        child = None
        for lvl in range(len(levels) - 2, -1, -1):
            lv = levels[lvl]
            a = (lv["masks"], stat[lvl], lv["dn"], lv["uoff"], lv["base"],
                 child, mt)
            per_level.insert(0, timed(lambda a=a: bf.bf_bwd(*a)))
            child = bf.bf_bwd(*a)
        out["ms"][f"{name} K14"] = sum(per_level)
        out["levels"][f"{name} K14"] = per_level
        out["launches"][f"{name} K14"] = len(levels) - 1

    tc, ta = bf.make_bf_tracer(flat.wbvh_nodes, blocks, meta)
    for name, wave, any_hit in cs.JOBS:
        rays = waves[wave]
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        _, segs = (ta if any_hit else tc).with_levels(o, d, rays[6], rays[7])
        seg = segs[0]
        stat = seg["stat"].to(dev)
        if "K15" in kernels:
            k15_levels(name, any_hit, o, d, rays)
        for which in ("K10", "K12"):
            if which in kernels:
                k10_k12_levels(name, seg, stat, which)
        if "K11" in kernels:
            k11_levels(name, seg, stat)
        if "K13" in kernels:
            k13_levels(name, any_hit, seg, stat)
        if "K14" in kernels:
            k14_levels(name, seg, stat)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
