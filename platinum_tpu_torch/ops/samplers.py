"""Counter-based QMC/RNG samplers and sampling warps, on torch tensors.

Port of platinum_tpu/ops/samplers.py:58-235 (the Z-sampler is in
ops/zsampler.py). Every value drawn for
(pixel, sample_index, dimension) is a pure function of those integers, as
in the JAX package, and equal to it bit for bit: the uint32 hash
arithmetic runs in int64 with `& 0xFFFFFFFF` after every multiply and add
(torch's uint32 supports few ops), and the Halton radical inverse
accumulates in float32 in the same order. Nothing here uses torch's
global RNG.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from platinum_tpu_torch.utils import telemetry

MASK32 = 0xFFFFFFFF
ONE_MINUS_EPS = float(np.float32(1.0 - 2 ** -24))
_INV_2_32 = float(np.float32(2.3283064365386963e-10))  # 2^-32
_MAX_DIGITS = 32


def _primes(n: int) -> np.ndarray:
    """First n primes."""
    out, cand = [], 2
    while len(out) < n:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return np.asarray(out, dtype=np.int64)


PRIME_TABLE = _primes(512)


def _u32(x) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 value."""
    return x.long() & MASK32


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> float32 in [0, 1), clamped below 1."""
    f = bits.to(torch.float32) * _INV_2_32
    return torch.clamp(f, max=ONE_MINUS_EPS)


def pcg4d_parts(x, y, z, w):
    """PCG4D hash (Jarzynski & Olano) over four uint32 lanes in int64."""
    x = (_u32(x) * 1664525 + 1013904223) & MASK32
    y = (_u32(y) * 1664525 + 1013904223) & MASK32
    z = (_u32(z) * 1664525 + 1013904223) & MASK32
    w = (_u32(w) * 1664525 + 1013904223) & MASK32
    for _ in range(2):
        x = (x + y * w) & MASK32
        y = (y + z * x) & MASK32
        z = (z + x * y) & MASK32
        w = (w + y * z) & MASK32
        if _ == 0:
            x, y, z, w = (t ^ (t >> 16) for t in (x, y, z, w))
    return x, y, z, w


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D over a stacked (..., 4) integer tensor (uint32 values)."""
    x, y, z, w = pcg4d_parts(v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    return torch.stack([x, y, z, w], dim=-1)


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer scramble hash (lowbias-style)."""
    x = _u32(x)
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK32
    return (x >> 16) ^ x


def _digit_weights(base: int) -> list:
    """The float32 weights f_k = f_{k-1} * (1/base) of the JAX loop, one per
    base-`base` digit a uint32 can have (later digits are 0 and add 0)."""
    inv_b = np.float32(1.0) / np.float32(base)
    weights, f, reach = [], np.float32(1.0), 1
    while reach <= MASK32 and len(weights) < _MAX_DIGITS:
        f = np.float32(f * inv_b)
        weights.append(float(f))
        reach *= base
    return weights


def radical_inverse_dynamic(index: torch.Tensor, base: int) -> torch.Tensor:
    """Radical inverse of `index` (uint32 values) in an integer `base`,
    equal to the JAX package's fixed 32-digit float32 loop.

    The digit weights are the same float32 sequence, computed once on the
    host, and the loop stops after the last digit a uint32 can have (the
    JAX loop adds exact zeros from there on). XLA compiles the loop's
    `r + f * digit` to one fused multiply-add, so it is formed here in
    float64 (a float32 times a digit below 2^12 is exact there) and
    rounded once to float32 per digit."""
    i = _u32(index)
    r = torch.zeros(i.shape, dtype=torch.float64, device=i.device)
    for f in _digit_weights(int(base)):
        r = (torch.remainder(i, base).double() * f + r).float().double()
        i = torch.div(i, base, rounding_mode="floor")
    return torch.clamp(r.float(), max=ONE_MINUS_EPS)


@dataclass(frozen=True)
class HaltonStream:
    """Halton sampler: per-(pixel, sample) PCG-hashed index into the Halton
    sequence; each draw consumes the next prime-base dimension. `dim` is a
    Python int: the bounce loop is a Python loop."""

    offset: torch.Tensor  # int64 holding uint32, one per ray
    dim: int = 0

    @staticmethod
    def create(pixel_x, pixel_y, sample_index) -> "HaltonStream":
        px = _u32(pixel_x)
        py = _u32(pixel_y)
        telemetry.count("sync.sample_index", not torch.is_tensor(sample_index))
        s = torch.broadcast_to(
            _u32(torch.as_tensor(sample_index, device=px.device)), px.shape)
        seed = torch.stack([px, py, s, (px + py) & MASK32], dim=-1)
        return HaltonStream(offset=pcg4d(seed)[..., 0], dim=0)

    def next_1d(self):
        u = radical_inverse_dynamic(self.offset, int(PRIME_TABLE[self.dim]))
        return replace(self, dim=self.dim + 1), u

    def next_2d(self):
        u0 = radical_inverse_dynamic(self.offset, int(PRIME_TABLE[self.dim]))
        u1 = radical_inverse_dynamic(self.offset,
                                     int(PRIME_TABLE[self.dim + 1]))
        return replace(self, dim=self.dim + 2), torch.stack([u0, u1], dim=-1)


@dataclass(frozen=True)
class PCG4DStream:
    """Pure hash-chain sampler: four (R,) uint32 planes (held in int64)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor

    @staticmethod
    def create(pixel_x, pixel_y, sample_index) -> "PCG4DStream":
        px = _u32(pixel_x)
        py = _u32(pixel_y)
        telemetry.count("sync.sample_index", not torch.is_tensor(sample_index))
        s = torch.broadcast_to(
            _u32(torch.as_tensor(sample_index, device=px.device)), px.shape)
        return PCG4DStream(*pcg4d_parts(px, py, s, (px + py) & MASK32))

    def next_1d(self):
        x, y, z, w = pcg4d_parts(self.x, self.y, self.z, self.w)
        return PCG4DStream(x, y, z, w), uniform_from_bits(x)

    def next_2d(self):
        x, y, z, w = pcg4d_parts(self.x, self.y, self.z, self.w)
        u = torch.stack([uniform_from_bits(x), uniform_from_bits(y)], dim=-1)
        return PCG4DStream(x, y, z, w), u


def make_stream(kind: str, pixel_x, pixel_y, sample_index,
                width: int = 4096, height: int = 4096, spp: int = 4096):
    """The sampler stream of `kind` for each (pixel, sample index); the
    Z-sampler also takes the image size and the sample budget, which set
    its Morton and sample digits."""
    kind = kind.lower()
    if kind == "halton":
        return HaltonStream.create(pixel_x, pixel_y, sample_index)
    if kind in ("pcg4d", "pcg"):
        return PCG4DStream.create(pixel_x, pixel_y, sample_index)
    if kind in ("z", "zsampler", "sobol"):
        from platinum_tpu_torch.ops.zsampler import ZStream

        return ZStream.create(pixel_x, pixel_y, sample_index, width, height,
                              spp)
    raise ValueError(f"unknown sampler kind: {kind}")


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------

def sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Uniform disk via sqrt-polar; u is (..., 2) -> (..., 2) xy."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_disk_polar(u: torch.Tensor) -> torch.Tensor:
    """Uniform disk in polar coords (r, theta)."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * np.pi * u[..., 1]
    return torch.stack([r, theta], dim=-1)


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere around +Z; u is (..., 2) -> (..., 3)."""
    phi = u[..., 0] * 2.0 * np.pi
    sin_theta = torch.sqrt(u[..., 1])
    cos_theta = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
        dim=-1)


def sample_tri_uniform(u: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics on a triangle (Heitz's mapping)."""
    ux, uy = u[..., 0], u[..., 1]
    lt = ux < uy
    b0 = torch.where(lt, ux * 0.5, ux - uy * 0.5)
    b1 = torch.where(lt, uy - ux * 0.5, uy * 0.5)
    return torch.stack([b0, b1], dim=-1)
