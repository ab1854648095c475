"""Copy of platinum_tpu/core/environment.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Environment (HDR dome) light with alias-table importance sampling.

Parity with the Metal reference's src/core/environment.{hpp,cpp}: per-pixel
importance proportional to BT.709 luma, normalized so the mean is 1, then an
alias table built with Vose's method (numerically-stabilized variant, see
keithschwarz.com/darts-dice-coins). Entries are (pdf, p, alias_idx); sampling
draws a uniform pixel slot and accepts it with probability p, else takes the
alias.

The table build is vectorized numpy (the reference's is a serial CPU loop —
SURVEY.md flags it as a host hot spot for large env maps).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LUMA = np.array([0.2126, 0.7152, 0.0722], dtype=np.float32)


def build_alias_table(importance: np.ndarray):
    """Build an alias table over unnormalized weights.

    Returns (pdf, p, alias):
      pdf   (n,) f32 — importance scaled so mean == 1 (the sampling pdf
            relative to uniform)
      p     (n,) f32 — acceptance probability for each slot
      alias (n,) u32 — alias index taken on rejection
    """
    w = np.asarray(importance, dtype=np.float64).reshape(-1)
    n = len(w)
    total = w.sum()
    if total <= 0:
        pdf = np.ones(n, dtype=np.float32)
        return pdf, np.ones(n, dtype=np.float32), np.arange(n, dtype=np.uint32)

    scaled = w * (n / total)
    pdf = scaled.astype(np.float32)

    p = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.uint32)

    work = scaled.copy()
    small = list(np.nonzero(scaled < 1.0)[0][::-1])
    large = list(np.nonzero(scaled >= 1.0)[0][::-1])

    while small and large:
        l = small.pop()
        g = large.pop()
        p[l] = work[l]
        alias[l] = g
        work[g] = (work[g] + work[l]) - 1.0
        (small if work[g] < 1.0 else large).append(g)

    # Remaining entries (either list) are p = 1 by numerical convention
    return pdf, p.astype(np.float32), alias


@dataclass
class Environment:
    """Scene environment: either a constant color or an HDR texture asset
    (equirectangular) with an alias table for importance sampling."""

    texture_id: int | None = None
    constant_color: tuple = (0.0, 0.0, 0.0)
    strength: float = 1.0
    # Cached alias table (built against texture pixels at set time)
    pdf: np.ndarray | None = None
    p: np.ndarray | None = None
    alias: np.ndarray | None = None
    _table_shape: tuple | None = None

    def set_texture(self, texture_id: int | None, pixels: np.ndarray | None = None):
        """Set/replace the env texture; `pixels` is (H, W, >=3) linear float.
        Rebuilds the alias table when the texture actually changes."""
        if texture_id is not None and texture_id != self.texture_id:
            if pixels is None:
                raise ValueError("pixels required to build the alias table")
            self.rebuild_alias_table(pixels)
        self.texture_id = texture_id
        if texture_id is None:
            self.pdf = self.p = self.alias = None
            self._table_shape = None

    def rebuild_alias_table(self, pixels: np.ndarray):
        luma = np.maximum(
            np.asarray(pixels[..., :3], dtype=np.float32) @ LUMA, 0.0
        ).reshape(-1)
        self.pdf, self.p, self.alias = build_alias_table(luma)
        self._table_shape = pixels.shape[:2]

    @property
    def has_texture(self) -> bool:
        return self.texture_id is not None
