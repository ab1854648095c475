"""Orthonormal shading frames and small vector helpers, over rays.

Port of platinum_tpu/ops/frame.py: Z-up frames built from a normal alone or
from normal + tangent (+ handedness), with the same degenerate-tangent
fallback (|n·t| > 0.9 -> normal-only frame). A frame is a tuple of three
(..., 3) tensors (t, b, n).
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean length along the last axis, sqrt of the sum of squares
    (jnp.linalg.norm's formula; torch.linalg.norm rescales)."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(norm(v, keepdim=True), min=eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b along the last axis, written out as jnp.cross computes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t with one rounded division (torch's `c / t` for c != 1 rounds
    twice: it computes t.reciprocal() * c)."""
    return torch.full_like(t, c) / t


_CONSTS: dict = {}


def const_like(values: tuple, like: torch.Tensor) -> torch.Tensor:
    """The vector `values` in `like`'s dtype on its device, expanded to
    `like`'s shape. The vector is made once per (values, dtype, device)
    by fills and kept: no copy from the host, so no sync, and nothing a
    CUDA graph capture refuses. One made while the current stream is
    capturing belongs to that graph and is not kept."""
    key = (values, like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = torch.stack([torch.full((), v, dtype=like.dtype,
                                    device=like.device) for v in values])
        if not (like.is_cuda and torch.cuda.is_current_stream_capturing()):
            _CONSTS[key] = c
    return c.expand(like.shape)


def from_normal(n: torch.Tensor):
    a = torch.where((torch.abs(n[..., 0]) > 0.5)[..., None],
                    const_like((0.0, 0.0, 1.0), n),
                    const_like((1.0, 0.0, 0.0), n))
    b = normalize(cross(n, a))
    t = cross(n, b)
    return t, b, n


def from_nt(n: torch.Tensor, t: torch.Tensor, sign: torch.Tensor):
    """Frame from normal + tangent with handedness sign; falls back to
    from_normal where the tangent is degenerate."""
    bad = torch.abs(dot(n, t)) > 0.9
    ft, fb, fn = from_normal(n)
    b = normalize(cross(n, t)) * sign[..., None]
    t2 = cross(b, n)
    sel = bad[..., None]
    return torch.where(sel, ft, t2), torch.where(sel, fb, b), n


def world_to_local(frame, w: torch.Tensor) -> torch.Tensor:
    t, b, n = frame
    return torch.stack([dot(w, t), dot(w, b), dot(w, n)], dim=-1)

