"""Z-sampler: Morton-indexed, base-4 permuted scrambled-Sobol sampler.

Port of platinum_tpu/ops/zsampler.py (the reference's ZSampler,
defs.metal:37-105, samplers.metal:62-152): the pixel's Morton index and
the sample index form a canonical base-4 index; each dimension permutes
its digits by a hash of their prefix, then evaluates a scrambled Sobol
point (the first two dimensions' matrices) with Laine-Karras-style
hashing. Every value equals the JAX package's bit for bit.

The uint32 arithmetic runs in int64 and is masked with `& 0xFFFFFFFF`
after every shift left, add and multiply, as ops/samplers.py does
(torch's uint32 supports few ops): so `z << log2_spp` wraps once the
Morton index and the sample bits pass 32 bits, as it does in JAX. A shift
right by 32 or more gives 0 there as in XLA. `dim` is a Python int (the
bounce loop is a Python loop), so its hashes are formed on the host, and
compaction, which takes the per-lane tensors, leaves it alone. The
draws' int64 -> float32 conversion rounds to nearest even, as
`astype(float32)` of a uint32 does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch

from platinum_tpu_torch.ops.samplers import MASK32, _u32, uniform_from_bits

# Sobol generator matrices for the first two dimensions: dim 1 is the
# van der Corput bit-reversal; dim 2 is the canonical Sobol second-dimension
# direction-number table (the 8-value doubling pattern).
Z_MATRIX_1 = np.array([1 << (31 - i) for i in range(32)], dtype=np.uint32)
Z_MATRIX_2 = np.array([
    0x80000000, 0xC0000000, 0xA0000000, 0xF0000000,
    0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
    0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000,
    0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
    0x80008000, 0xC000C000, 0xA000A000, 0xF000F000,
    0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
    0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0,
    0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF,
], dtype=np.uint32)

# All 24 permutations of (0,1,2,3) in the reference's order
PERMUTATIONS = np.array([
    [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
    [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
    [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
    [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
    [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
    [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2],
], dtype=np.uint32)


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(the permutations flattened for one gather, row * 4 + digit;
    Z_MATRIX_2's columns; the shifts of a uint32's 32 bits) on `device`,
    uploaded once."""
    return (torch.from_numpy(PERMUTATIONS.reshape(-1).astype(np.int64))
            .to(device),
            torch.from_numpy(Z_MATRIX_2.astype(np.int64)).to(device),
            torch.arange(32, device=device))


def _host_hash_u32(x: int) -> int:
    """ops/samplers.hash_u32 of one Python int."""
    x &= MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & MASK32
    return (x >> 16) ^ x


def _reverse_bits32(v):
    v = ((v << 16) | (v >> 16)) & MASK32
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    v = ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)
    return v


def _z_hash(i, d: int):
    """Per-prefix permutation hash (samplers.metal:104-111); `d` is the
    dimension, a Python int."""
    i = i ^ ((0x55555555 * d) & MASK32)
    x = (i * 0x9E377A) & 0xFFFFFF
    return (x * 24) >> 24


def _scramble(v, seed: int):
    v = _reverse_bits32(v)
    v = v ^ ((v * 0x3D20ADEA) & MASK32)
    v = (v + seed) & MASK32
    v = (v * ((seed >> 16) | 1)) & MASK32
    v = v ^ ((v * 0x05526C56) & MASK32)
    v = v ^ ((v * 0x53A22864) & MASK32)
    return _reverse_bits32(v)


def _sobol1(index, dim: int):
    """Dimension 1: Z_MATRIX_1 maps bit i to bit 31 - i, so the XOR of its
    columns over the index's bits is the index's bit reversal."""
    return _scramble(_reverse_bits32(index), _host_hash_u32(dim))


def _sobol2(index, dim: int):
    """Dimension 2: the XOR of Z_MATRIX_2's columns over the index's set
    bits, reduced over the 32 columns in five halvings."""
    _, cols, shifts = _tables(index.device)
    v = ((index[..., None] >> shifts) & 1) * cols
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] ^ v[..., h:]
    return _scramble(v[..., 0], _host_hash_u32(dim))


@dataclass(frozen=True)
class ZStream:
    z: torch.Tensor   # (R,) int64 holding the uint32 canonical index
    dim: int          # the next dimension

    log2_res: int
    log2_spp: int
    base4_digits: int

    @staticmethod
    def create(pixel_x, pixel_y, sample_index, width: int = 4096,
               height: int = 4096, spp: int = 4096) -> "ZStream":
        px = _u32(pixel_x)
        py = _u32(pixel_y)
        resolution = max(width, height)
        log2_res = max(1, int(np.ceil(np.log2(max(resolution, 2)))))
        log2_spp = int(np.ceil(np.log2(max(spp, 1)))) if spp > 1 else 0
        base4_digits = log2_res + (log2_spp + 1) // 2

        z = torch.zeros_like(px)
        for i in range(log2_res):
            z = z | ((((px >> i) & 1) << (2 * i)) & MASK32)
            z = z | ((((py >> i) & 1) << (2 * i + 1)) & MASK32)
        s = torch.broadcast_to(
            _u32(torch.as_tensor(sample_index, device=px.device)), px.shape)
        z = ((z << log2_spp) & MASK32) | s
        if log2_spp & 1:
            z = ((z << 1) & MASK32) | (s & 1)
        return ZStream(z=z, dim=0, log2_res=log2_res, log2_spp=log2_spp,
                       base4_digits=base4_digits)

    def _index(self):
        """Permuted sample index for the current dimension
        (samplers.metal:113-138)."""
        d = self.dim
        perm = _tables(self.z.device)[0]
        z_pi = torch.zeros_like(self.z)
        for j in range(self.log2_spp & 1, self.base4_digits):
            x = self.z >> (2 * (self.base4_digits - j - 1))
            digit = perm[_z_hash(x >> 2, d) * 4 + (x & 3)]
            z_pi = ((z_pi << 2) & MASK32) | digit
        if self.log2_spp & 1:
            bit = (self.z & 1) ^ (_z_hash(self.z >> 1, d) & 1)
            z_pi = ((z_pi << 1) & MASK32) | bit
        return z_pi

    def next_1d(self):
        u = uniform_from_bits(_sobol1(self._index(), self.dim))
        return replace(self, dim=self.dim + 1), u

    def next_2d(self):
        idx = self._index()
        u = torch.stack([uniform_from_bits(_sobol1(idx, self.dim)),
                         uniform_from_bits(_sobol2(idx, self.dim))], -1)
        return replace(self, dim=self.dim + 1), u

    def skip(self, n: int):
        return replace(self, dim=self.dim + n)
