"""Table lookups as plain indexing.

Port of platinum_tpu/ops/lookup.py. The JAX package routes every hot-path
lookup through where-chains or one-hot matmuls because a per-lane gather is
slow on its TPU toolchain (lookup.py:1-22); a GPU gathers natively, so
each strategy here is one indexing operation with the same results.
"""

from __future__ import annotations

import torch


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (M, K); idx: (R,) integer in [0, M). Returns (R, K)."""
    return table[idx.long()]


def interp_rows(table: torch.Tensor, idx: torch.Tensor,
                frac: torch.Tensor) -> torch.Tensor:
    """(1-frac)*table[idx] + frac*table[min(idx+1, M-1)], in the JAX
    package's op order."""
    idx = idx.long()
    r0 = table[idx]
    r1 = table[torch.clamp(idx + 1, max=table.shape[0] - 1)]
    return r0 * (1.0 - frac[..., None]) + r1 * frac[..., None]

