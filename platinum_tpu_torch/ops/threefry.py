"""Threefry-2x32 counter-based random numbers, bitwise equal to jax.random.

Port of the three `jax.random` calls that wavefront compaction makes
(platinum_tpu/render/integrator.py:625, :757-766): `PRNGKey(seed)`,
`fold_in(key, data)` and `uniform(key, (n,))`, with JAX's default
threefry implementation in its partitionable layout
(`jax_threefry_partitionable=True`, the default since JAX 0.5): element i
of a draw hashes the 64-bit counter i as the pair (hi, lo) = (0, i) under
the key, and its 32 random bits are the XOR of the two output words.
`uniform` then keeps the top 23 bits as the mantissa of a float in [1, 2)
and subtracts 1.

torch has little uint32 support, so words are held in int64 tensors (or
Python ints, for keys) and masked to 32 bits after every addition and
shift. Keys are pairs of Python ints; only `uniform` touches a device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    the key (k1, k2), as jax._src.prng's lowering computes it. x1, x2:
    Python ints or int64 tensors holding uint32 values."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ _PARITY) & MASK32)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def PRNGKey(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the key (0, seed)."""
    if not -(1 << 31) <= int(seed) < (1 << 32):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return (0, int(seed) & MASK32)


def fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in(key, data): the hash of the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def random_bits(key: tuple, n: int, device="cpu") -> torch.Tensor:
    """jax.random.bits(key, (n,)) under the partitionable layout: (n,)
    int64 holding uint32 values."""
    if n >= 1 << 32:
        raise ValueError("draws of 2^32 or more values are not supported")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: tuple, n: int, device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, (n,)): float32 in [0, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
