"""Arithmetic over a profiled stretch: device busy share, kernel time by
kind, launches, host synchronisations and the breakdown.

The busy-share, kernel-time and launch arithmetic is copied from
tools/torch_time_paths.py's `--profile` (device time of every CUDA
kernel, the trace kernels' by name, `cudaLaunchKernel` counted); here
busy time is the union of device intervals inside the window rather than
a sum, so overlapping operations count once. Everything works on plain
tuples, so a recorded table can be fed to it without a card:

- device: (name, start_us, end_us) of every operation that ran on the
  device (kernels, copies, sets);
- host: (name, start_us, end_us) of every host-side event (operators and
  CUDA runtime calls), the window marker included.
"""

from __future__ import annotations

import os

WINDOW = "portbench.window"
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaLaunchCooperativeKernel"})
# runtime calls that return only once the device has caught up
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                   "cudaMemcpy3D", "cuStreamSynchronize",
                   "cuCtxSynchronize"})
NOT_KERNELS = ("Memcpy", "Memset")
TRACE_KERNELS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "trace_kernels.txt")


def trace_patterns(path: str = TRACE_KERNELS_FILE) -> tuple:
    """The substrings that name a trace kernel, one a line."""
    with open(path) as f:
        return tuple(s.strip() for s in f if s.strip()
                     and not s.startswith("#"))


def from_profiler(prof) -> tuple:
    """(device, host) tuples of a finished torch.profiler.profile."""
    import torch

    device, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name != WINDOW:        # the marker's device-side copy
                device.append(row)
        else:
            host.append(row)
    return device, host


def _union(intervals):
    """Merged, sorted (start, end) of overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(device, host, patterns, top: int = 10) -> dict:
    """Seconds of the window, of device busy time inside it, of trace and
    other kernels; launches and synchronising calls inside it; the
    `top` device operations by time and the `top` idle gaps, each named
    by the innermost host event running at its middle."""
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        raise ValueError(f"no {WINDOW!r} event in the host table")
    w0, w1 = win[0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in inside])
    trace_us = other_us = 0.0
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        if n.startswith(NOT_KERNELS):
            continue
        if any(p in n for p in patterns):
            trace_us += e - s
        else:
            other_us += e - s
    calls = [(n, s, e) for n, s, e in host if w0 <= s <= w1]
    gaps = []
    edges = [[w0, w0]] + busy + [[w1, w1]]
    for a, b in zip(edges, edges[1:]):
        if b[0] > a[1]:
            gaps.append((a[1], b[0]))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        cover = [(e - s, n) for n, s, e in calls
                 if s <= mid <= e and n != WINDOW]
        named.append([min(cover)[1] if cover else "python (no operator)",
                      (g1 - g0) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        trace_kernel_s=trace_us * 1e-6,
        other_kernel_s=other_us * 1e-6,
        trace_launches=sum(1 for n, _, _ in inside
                           if any(p in n for p in patterns)),
        launches=sum(1 for n, _, _ in calls if n in LAUNCHES),
        syncs=sum(1 for n, _, _ in calls if n in SYNCS),
        device_ops=[[n[:160], t * 1e-6] for n, t in ops],
        idle_gaps=named)
