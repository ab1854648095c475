"""Registers, stack frame and spills of every kernel instantiation.

    python3 tools/torch_kernel_resources.py [wide_trace] [stream_mt] [bf_stream]
        [bsdf_shade] [hit_fetch]

Compiles each source of platinum_tpu_torch/csrc with the package's nvcc
flags plus `--resource-usage` into a temporary file and prints, per
instantiation (its template arguments as nvcc mangles them), what ptxas
reports, then the instantiation count and the compile time. Needs nvcc; it
launches nothing.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from platinum_tpu_torch.ops import packet_trace as pt  # noqa: E402


def resources(name: str):
    source = os.path.join(pt.CSRC_DIR, name + ".cu")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [pt._nvcc(), *pt.NVCC_FLAGS, *pt.SOURCE_FLAGS.get(name, []),
             "--resource-usage", "-o",
             os.path.join(tmp, name + ".so"), source],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    rows = []
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            continue
        if "bytes stack frame" in line:
            stack = re.findall(r"(\d+) bytes (stack frame|spill stores|"
                               r"spill loads)", line)
            rows.append([kernel, {k: int(v) for v, k in stack}])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1][1]["registers"] = int(m.group(1))
    return rows, seconds


def demangle(names):
    try:
        out = subprocess.run(["cu++filt", *names], capture_output=True,
                             text=True, check=True).stdout.splitlines()
        return [re.sub(r">\(.*", ">", o) for o in out]
    except (OSError, subprocess.CalledProcessError):
        return names


def main():
    for name in sys.argv[1:] or ("wide_trace", "stream_mt", "bf_stream",
                                 "bsdf_shade", "hit_fetch"):
        rows, seconds = resources(name)
        for label, (_, r) in zip(demangle([k for k, _ in rows]), rows):
            print(f"{label}: {r.get('registers')} registers, "
                  f"{r.get('stack frame')} B stack, "
                  f"{r.get('spill stores')} B spill stores, "
                  f"{r.get('spill loads')} B spill loads")
        print(f"{name}.cu: {len(rows)} instantiations compiled in "
              f"{seconds:.1f} s", flush=True)


if __name__ == "__main__":
    main()
