"""Time the wide-BVH kernel per wave on the GPU: K1/K2, the streamed mode
(K6: each node's leaves queued and drained after its slab tests, each
queued block prefetched into L2 for closest hit), the octant order's
closest hit (K7, `oct`) and the pipelined walk (K9 `pipe`, and `flat`
with the flat push) on the waves chip_smoke.py builds for the headline
colonnade (271k triangles, 512x512) and for bistro_class_studio's tree
(the colonnade at 24x12, 1.08M triangles, 960x540), and K3, K7 and K9
(`k1`, `oct`, `pipe`, `flat` given the instance features) on the
headline's waves over the colonnade flattened with instancing="on": the
camera and bounce waves as closest hit, the shadow wave as any hit (not
`oct`: the packet tracer orders closest hit only) and as closest hit;
with --tiers also the closest hit of the reduced MT tiers on the
headline tree (K4 "high" and "default", K5 "two_phase"), given the
blocks' pre-split planes where the checkout has them.

    python3 tools/torch_time_waves.py [--tiers] [--headline]
    python3 tools/torch_time_waves.py --root OTHER_CHECKOUT --counts A.pt
    python3 tools/torch_time_waves.py --compare A.pt B.pt

`--root` imports platinum_tpu_torch and chip_smoke.py (its `_wave_points`,
`_waves`, `JOBS` and `_time_ms`) from another checkout, so two versions of
the kernel can be timed in turns within one call on one card; --headline
skips the bistro tree. Prints one
JSON line: the card and its power limit, and per tree, wave and mode the
kernel's ms per wave (CUDA events around --reps launches after one
warm-up). Needs a CUDA device.

`--counts FILE` also saves, per tree, the node pops, MT block tests and
instance entries per ray (rows 0-2 of `trace_wide_counts(per_ray=True)`)
of the any-hit trace of the shadow wave (K2 on the headline tree, the
instanced any hit, K6 any hit on the bistro tree), of `oct` on the bounce
wave and of `pipe` and `flat` on the bounce (closest hit) and shadow (any
hit) waves, with torch.save; `--compare A B` (no device needed) prints,
for two such files from two checkouts, the rays whose node pops, MT block
tests or instance entries differ and the totals of each, so that a
redesigned walk is held ray by ray to the walk it replaces.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (name, make_colonnade_scene's arguments, size, instancing)
TREES = (("headline", {}, (512, 512), "off"),
         ("instanced", {}, (512, 512), "on"),
         ("bistro", dict(columns=24, rows=12), (960, 540), "off"))
MODES = (("k1", {}), ("stream", dict(stream=True)), ("oct", None),
         ("pipe", dict(pipe=True)), ("flat", dict(flat_walk=True,
                                                  checked=True)))
COUNTED = (("bounce", False, "oct"), ("bounce", False, "pipe"),
           ("shadow", True, "pipe"), ("bounce", False, "flat"),
           ("shadow", True, "flat"))
TIERS = ("high", "default", "two_phase")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tiers", action="store_true")
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--counts")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    import platinum_tpu_torch
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    for mod in (cs, platinum_tpu_torch):
        if not mod.__file__.startswith(root):
            raise SystemExit(f"imported {mod.__file__}, not {root}'s")
    dev = torch.device("cuda", 0)
    pt.build_kernel()
    out = dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), root=args.root, ms={})
    by_name = {t[0]: t for t in TREES}
    pts_of = {}
    counts = {}

    def flatten(tree, instancing):
        _, scene_kw, (width, height), _ = by_name[tree]
        scene, cam = make_colonnade_scene(**scene_kw)
        return flatten_scene(scene, cam, RenderSettings(
            width=width, height=height, tracer="packet",
            instancing=instancing, stream="auto"), device=dev)

    def points(tree, flat=None):
        """The wave points of one-level tree `tree` (from its `flat`, or
        flattened here)."""
        if tree not in pts_of:
            if flat is None:
                flat = flatten(tree, "off")
            pts_of[tree] = cs._wave_points(flat, dev, *by_name[tree][2])
        return pts_of[tree]

    for tree, _, _, instancing in TREES[:2] if args.headline else TREES:
        flat = flatten(tree, instancing)
        nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
        blocks, meta = flat.wbvh_tris, flat.wbvh_meta
        inst = flat.instances.feat if instancing == "on" else None
        # the instanced tree takes the headline's points
        pts = points(tree, flat) if inst is None else points("headline")
        waves = cs._waves(pts, nodes, dev)
        modes = [(m, dict(worder=flat.wbvh_order) if m == "oct" else kw)
                 for m, kw in MODES if inst is None or m != "stream"]
        if args.tiers and tree == "headline":
            split = ({"planes": pt.split_planes(blocks)}
                     if hasattr(pt, "split_planes") else {})
            modes += [(t, dict(mt_precision=t, **split)) for t in TIERS]
        for _, wave, any_hit in (*cs.JOBS, ("", "shadow", False)):
            for mode, kw in modes:
                if any_hit and ("mt_precision" in kw or "worder" in kw):
                    continue           # any hit: K2 under every tier,
                                       # not ordered by the tracer
                kind = " closest" if wave == "shadow" and not any_hit else ""
                out["ms"][f"{tree} {wave}{kind} {mode}"] = cs._time_ms(
                    lambda: pt.trace_wide(waves[wave], nodes, blocks, meta,
                                          any_hit, inst, **kw), args.reps)
        if args.counts:
            counts[f"{tree} shadow any"] = pt.trace_wide_counts(
                waves["shadow"], nodes, blocks, meta, True, inst,
                per_ray=True)[:3].cpu()
            kws = dict(modes)
            for wave, any_hit, mode in COUNTED:
                counts[f"{tree} {wave}{' any' if any_hit else ''} {mode}"] = (
                    pt.trace_wide_counts(waves[wave], nodes, blocks, meta,
                                         any_hit, inst, per_ray=True,
                                         **kws[mode])[:3].cpu())
        del flat, nodes, blocks, meta, waves, inst
        torch.cuda.empty_cache()
    if args.counts:
        import torch

        torch.save(counts, args.counts)
    print(json.dumps(out), flush=True)


ROWS = ("pops", "MT block tests", "instance entries")


def compare(path_a, path_b):
    """Per tree, the rays whose pops, MT block tests or instance entries
    differ between two `--counts` files, and each file's totals."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    for key in a:
        if key not in b:
            continue
        ca, cb = a[key], b[key]
        if ca.shape != cb.shape:
            print(f"{key}: {tuple(ca.shape)} against {tuple(cb.shape)} rays")
            continue
        parts = [f"{name}: {int(ca[r].sum())} / {int(cb[r].sum())}, "
                 f"{int((ca[r] != cb[r]).sum())} rays differ"
                 for r, name in enumerate(ROWS)]
        print(f"{key}, {ca.shape[1]} rays, {path_a} / {path_b}: "
              + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
