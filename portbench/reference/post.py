"""The plain reference of the display image: the program's post stack at
its default options (no exposure, aberration, contrast, saturation, tone
curve or vignette; AgX with no look; neutral lift-gamma-gain; BT.709 out;
the sRGB encoding), one pixel at a time, written again in plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from .pathtracer import _bt709_identity

LUMA = (0.2126, 0.7152, 0.0722)
AGX_IN = np.column_stack([
    (0.842479062253094, 0.0423282422610123, 0.0423756549057051),
    (0.0784335999999992, 0.878468636469772, 0.0784336),
    (0.0792237451477643, 0.0791661274605434, 0.879142973793104),
]).astype(np.float32)
AGX_OUT = np.column_stack([
    (1.19687900512017, -0.0528968517574562, -0.0529716355144438),
    (-0.0980208811401368, 1.15190312990417, -0.0980434501171241),
    (-0.0990297440797205, -0.0989611768448433, 1.15107367264116),
]).astype(np.float32)
MIN_EV, MAX_EV = -12.47393, 4.026069


def _mul(m, v):
    m = torch.as_tensor(m, dtype=v.dtype, device=v.device)
    return v[:, 0:1] * m[:, 0] + v[:, 1:2] * m[:, 1] + v[:, 2:3] * m[:, 2]


def _luma(v):
    return torch.sum(v * torch.tensor(LUMA, dtype=v.dtype, device=v.device),
                     -1, keepdim=True)


def display(rgb: torch.Tensor) -> torch.Tensor:
    """(P, 3) linear BT.709 radiance -> (P, 3) display-encoded sRGB."""
    eps = 1e-6
    mid = float(np.log2(0.18))
    c = rgb * 1.0
    c = torch.clamp(torch.exp2(mid + 1.0 * (torch.log2(
        torch.clamp(c, min=0.0) + eps) - mid)) - eps, min=0.0)
    gray = _luma(c)
    c = gray + 1.0 * (c - gray)
    v = _mul(AGX_IN, c)
    v = torch.clamp(torch.log2(torch.clamp(v, min=1e-10)), MIN_EV, MAX_EV)
    x = (v - MIN_EV) / (MAX_EV - MIN_EV)
    x2 = x * x
    x4 = x2 * x2
    v = (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
         + 0.4298 * x2 + 0.1191 * x - 0.00232)
    luma = _luma(v)
    v = luma + 1.0 * (torch.clamp(v, min=0.0) - luma)
    v = torch.clamp(_mul(AGX_OUT, v), 0.0, 1.0)
    v = torch.clamp(torch.pow(torch.clamp(v, min=0.0), 2.2), 0.0, 1.0)
    v = torch.clamp(_mul(_bt709_identity(), v), min=0.0)
    v = torch.where(v < 0.0031308, 12.92 * v,
                    1.055 * torch.pow(v, 1.0 / 2.4) - 0.055)
    return torch.clamp(v, 0.0, 1.0)
