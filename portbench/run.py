"""The benchmark of platinum_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the card, then, as the last lines of
standard error, each number the comparison held against its limit, and
as the last line of standard output one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, breakdown (--trace 1) and checks. Exits 2
without a result when no CUDA device (or too few) is present, and 3 when
a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from portbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = harness.find_cell(bench, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"portbench: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {smi.stdout.strip()}",
          file=sys.stderr, flush=True)
    out = harness.run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
