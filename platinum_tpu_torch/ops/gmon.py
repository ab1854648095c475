"""GMoN (Gini-weighted median of means) robust sample combination, in torch.

Port of platinum_tpu/ops/gmon.py (parity with gmon.metal:14-55): per
pixel, sort the per-bucket mean estimates by luma, compute the Gini
coefficient G of the luma distribution (capped by an option), and average
the middle nBuckets - 2 * int(G * nBuckets / 2) buckets: the full mean
when the estimates agree (G -> 0), the median when they do not (G -> 1).

The sort is stable, as jnp.argsort is: equal lumas are common (black
pixels, buckets that share a colour), and the order of ties decides which
bucket's RGB enters the window.
"""

from __future__ import annotations

import torch

LUMA = (0.2126, 0.7152, 0.0722)


def gmon_window(buckets: torch.Tensor, n_full: int, cap: float = 1.0):
    """The estimator's choice per pixel: (order (B, R), the buckets sorted
    by luma, stable; in_window (B, R), which sorted positions the mean
    takes). buckets: (B, R, 3), only the first n_full valid; invalid
    buckets sort to +inf luma and stay out of the window."""
    b = buckets.shape[0]
    dev = buckets.device
    idx = torch.arange(b, device=dev)[:, None]
    valid = idx < n_full

    luma = torch.sum(buckets * torch.tensor(LUMA, device=dev), dim=-1)
    luma_sortkey = torch.where(valid, luma, float("inf"))
    order = torch.sort(luma_sortkey, dim=0, stable=True).indices
    sorted_luma = torch.take_along_dim(torch.where(valid, luma, 0.0), order,
                                       dim=0)
    sorted_valid = torch.take_along_dim(valid.expand_as(luma), order, dim=0)

    n = torch.tensor(float(n_full), device=dev)     # f32, as in JAX
    ranks = (torch.arange(b, dtype=torch.float32, device=dev) + 1.0)[:, None]
    s = torch.sum(sorted_luma, dim=0)
    ws = torch.sum(ranks * sorted_luma * sorted_valid, dim=0)
    g = (2.0 * ws) / torch.clamp(n * s, min=1e-20) - (n + 1.0) / n
    g = torch.clamp(g, 0.0, cap)

    c = torch.floor(g * float(n_full // 2)).to(torch.int32)
    lo = c[None, :]
    hi = (n_full - c)[None, :]
    return order, (idx >= lo) & (idx < hi) & sorted_valid


def gmon_combine(buckets: torch.Tensor, n_full: int,
                 cap: float = 1.0) -> torch.Tensor:
    """buckets: (B, R, 3) per-bucket running means (only the first n_full
    are valid); returns the (R, 3) robust estimate: the mean of the
    buckets in gmon_window's window."""
    order, in_window = gmon_window(buckets, n_full, cap)
    sorted_vals = torch.take_along_dim(buckets, order[..., None], dim=0)
    count = torch.clamp(torch.sum(in_window, dim=0), min=1)
    total = torch.sum(torch.where(in_window[..., None], sorted_vals, 0.0),
                      dim=0)
    return total / count[..., None]
