"""The comparison that decides `correct`.

After the window the program's accumulated image (and, in a cell that
displays, its last display image) is held against the plain reference at
pixels drawn from the seed. The reference is the module the cell's
configuration names (reference/<name>.py, `pathtracer` by default): its
`radiance(arrays, width, height, max_bounces, pixels, samples,
light_rows, device, dtype)` returns ((P, S, 3) float32 radiance, the
light_rows gap). It renders those pixels at every
sample index the run rendered (the warm step's sample 0 and the window's
s0 .. s0 + n - 1), blends them with the Renderer's running-mean formula
(the warm image resumed as s0 samples, then one sample a step), and, in a
displaying cell, passes them through its own post stack.

Numbers compared (each with its limit from checks/<cell>.json):
- pixels_off: the share of the drawn pixels whose relative gap (largest
  channel difference over the reference's largest channel, floored at a
  thousandth of the drawn pixels' mean) exceeds `rel_tol`. Rounding can
  send a rare path another way, so a sound run reads a small share;
- gap_median: the median relative gap, steady from seed to seed;
- display_off: in a displaying cell, the share of drawn pixels whose
  display value differs by more than `display_tol` in some channel;
- light_rows: the widest corner gap between the program's emissive
  triangles and the reference's (the one thing the reference takes from
  the program, their order, is checked here).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import post


def draw_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(
        n_pixels, size=min(count, n_pixels), replace=False))


def expected(rad: torch.Tensor, first: int) -> torch.Tensor:
    """The Renderer's accumulator over (P, S, 3) sample radiance: sample 0
    is the warm step, resumed as `first` samples; samples 1.. are one
    step each, blended as (acc * k + r) / (k + 1) in float32."""
    acc = rad[:, 0]
    k = float(first)
    for j in range(1, rad.shape[1]):
        acc = (acc * k + rad[:, j]) / (k + 1.0)
        k += 1.0
    return acc


def reference_image(reference, arrays, settings, pixels, first, steps,
                    light_rows, device, dtype=torch.float32):
    """(accumulated radiance (P, 3), display (P, 3), light_rows gap) of
    the reference module `reference`."""
    samples = [0] + list(range(first, first + steps))
    rad, gap = reference.radiance(arrays, settings["width"],
                                  settings["height"],
                                  settings["max_bounces"], pixels, samples,
                                  light_rows, device, dtype)
    acc = expected(rad, first)
    return acc, post.display(acc), gap


def gaps(acc_prog: np.ndarray, acc_ref: np.ndarray) -> np.ndarray:
    """Per-pixel relative gap of (P, 3) images."""
    mag = np.abs(acc_ref).max(-1)
    floor = 1e-3 * max(float(mag.mean()), 1e-12)
    return np.abs(acc_prog - acc_ref).max(-1) / np.maximum(mag, floor)


def numbers(check: dict, acc_prog, acc_ref, disp_prog=None, disp_ref=None,
            light_gap=0.0) -> dict:
    """{name: value} of every number the cell compares."""
    g = gaps(acc_prog, acc_ref)
    out = dict(pixels_off=float((g > check["rel_tol"]).mean()),
               gap_median=float(np.median(g)),
               light_rows=float(light_gap))
    if disp_prog is not None:
        d = np.abs(disp_prog - disp_ref).max(-1)
        out["display_off"] = float((d > check["display_tol"]).mean())
    return out


def judge(check: dict, values: dict) -> dict:
    """{name: {"value", "limit"}} and whether every value is within."""
    table = {k: dict(value=v, limit=check["limits"][k])
             for k, v in values.items()}
    return table, all(t["value"] <= t["limit"] for t in table.values())
