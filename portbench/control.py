"""The control of the comparison: the plain reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32, at a cell's own size. It has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --steps 124

For each seed it renders the seed's pixels at the samples a run of
`--steps` window steps renders, once in float32 (the reference) and once
in bfloat16 (the control, whose light table, accumulator inputs and
display are bfloat16 too), and prints the numbers `compare.numbers`
gives beside the cell's limits. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(spec: dict, seed: int, steps: int, device) -> dict:
    from portbench import compare, harness, scenes
    from portbench.reference import pathtracer, post

    traffic, check = spec["traffic"], spec["check"]
    settings = dict(spec["config"]["settings"])
    arrays = scenes.make(spec["config"])
    w, h = traffic["width"], traffic["height"]
    first = 1 + seed % harness.FIRST_SAMPLES
    pixels = compare.draw_pixels(seed, w * h, check["pixels"])
    scene = pathtracer.compile_scene(arrays, w, h)
    rows, total = pathtracer.light_table(scene, scene["light_tris"])
    samples = [0] + list(range(first, first + steps))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = pathtracer.device_tables(scene, rows, total, device, dtype)
        rad = pathtracer.render_pixels(t, pixels, samples,
                                       settings["max_bounces"], dtype)
        acc = compare.expected(rad, first)
        disp = post.display(acc.to(dtype)).float()
        out[dtype] = (acc.cpu().numpy(), disp.cpu().numpy())
    rows16 = torch.from_numpy(rows[:, :9]).to(torch.bfloat16).float().numpy()
    (a32, d32), (a16, d16) = out[torch.float32], out[torch.bfloat16]
    return compare.numbers(check, a16, a32,
                           d16 if traffic["display"] else None,
                           d32 if traffic["display"] else None,
                           float(np.abs(rows16 - rows[:, :9]).max()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from portbench import compare, harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = harness.find_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(spec, seed, args.steps, args.device)
        table, correct = compare.judge(spec["check"], nums)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              steps=args.steps, correct=correct,
                              checks=table)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
