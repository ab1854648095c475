"""The control of the comparison: the plain reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32, at a cell's own size. It has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --steps 124

For each seed it renders the seed's pixels at the samples a run of
`--steps` window steps renders through the `radiance` of the reference
the cell's configuration names, once in float32 (the reference) and once
in bfloat16 (the control, whose light table, accumulator inputs and
display are bfloat16 too), and prints the numbers `compare.numbers`
gives beside the cell's limits. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(spec: dict, seed: int, steps: int, device) -> dict:
    from portbench import compare, harness, scenes
    from portbench.reference import post

    traffic, check = spec["traffic"], spec["check"]
    settings = dict(spec["config"]["settings"])
    arrays = scenes.make(spec["config"], spec["generators_dir"])
    w, h = traffic["width"], traffic["height"]
    first = 1 + seed % harness.FIRST_SAMPLES
    pixels = compare.draw_pixels(seed, w * h, check["pixels"])
    samples = [0] + list(range(first, first + steps))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        # the reference's own light order; the gap is that of its light
        # rows as held in `dtype`
        rad, gap = spec["reference"].radiance(arrays, w, h,
                                              settings["max_bounces"], pixels,
                                              samples, None, device, dtype)
        acc = compare.expected(rad, first)
        disp = post.display(acc.to(dtype)).float()
        out[dtype] = (acc.cpu().numpy(), disp.cpu().numpy(), gap)
    (a32, d32, _), (a16, d16, gap16) = out[torch.float32], out[torch.bfloat16]
    return compare.numbers(check, a16, a32,
                           d16 if traffic["display"] else None,
                           d32 if traffic["display"] else None, gap16)


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
