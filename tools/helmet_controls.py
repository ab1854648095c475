"""The two controls of the `helmet_env` cell's comparison, which must both
come out as not correct, on the GPU:

    python3 tools/helmet_controls.py --seeds 11,12,13 --steps 300

For each seed it renders the seed's pixels at the samples a run of
`--steps` window steps renders through portbench/reference/helmet_env.py
in float32 (the reference) and holds against it, under the cell's limits,
(1) the same reference in bfloat16 (portbench/control.py's control) and
(2) the reference with the emission texel left out of NEE, the
estimator before textured emitters were made right
(`estimator="untextured_nee"`). Prints one JSON line a seed and control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "helmet_env.final_1080p"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import compare, harness, scenes

    spec = harness.find_cell(harness.load_json(
        os.path.join(ROOT, "BENCHMARK.json")), WORKLOAD)
    traffic, check = spec["traffic"], spec["check"]
    ref = spec["reference"]
    arrays = scenes.make(spec["config"], spec["generators_dir"])
    w, h = traffic["width"], traffic["height"]
    bounces = spec["config"]["settings"]["max_bounces"]
    for seed in (int(s) for s in args.seeds.split(",")):
        first = 1 + seed % harness.FIRST_SAMPLES
        pixels = compare.draw_pixels(seed, w * h, check["pixels"])
        samples = [0] + list(range(first, first + args.steps))
        accs = {}
        for name, kw in (("reference", {}),
                         ("bfloat16", dict(dtype=torch.bfloat16)),
                         ("untextured_nee",
                          dict(estimator="untextured_nee"))):
            rad, gap = ref.radiance(arrays, w, h, bounces, pixels, samples,
                                    None, args.device, **kw)
            accs[name] = (compare.expected(rad, first).float().cpu().numpy(),
                          gap)
        for name in ("bfloat16", "untextured_nee"):
            nums = compare.numbers(check, accs[name][0],
                                   accs["reference"][0],
                                   light_gap=accs[name][1])
            table, correct = compare.judge(check, nums)
            print(json.dumps(dict(workload=WORKLOAD, control=name, seed=seed,
                                  steps=args.steps, correct=correct,
                                  checks=table)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
