"""Copy of platinum_tpu/core/texture.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Texture asset (host-side).

Parity with the Metal reference's src/core/texture.hpp plus the loader's format
conversion (the Metal reference's src/loaders/texture.{hpp,cpp}): decoded images are
converted on import to one of a small set of canonical formats. On TPU there
are no texture samplers or sRGB hardware, so formats describe *semantics*;
storage is always a numpy array, and sRGB decode happens at flatten/sample
time.

Formats (mirroring the reference's convertTexture targets):
  SRGB_RGBA    8-bit color + alpha, sRGB-encoded (base color, emission)
  LINEAR_RGBA  8-bit linear RGBA (normal maps)
  MONO         8-bit single channel (transmission, clearcoat)
  ROUGH_METAL  8-bit 2-channel: (roughness, metallic) from source (G, B)
  HDR          float32 RGBA (environment maps)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TextureFormat(enum.Enum):
    SRGB_RGBA = "srgb_rgba"
    LINEAR_RGBA = "linear_rgba"
    MONO = "mono"
    ROUGH_METAL = "rough_metal"
    HDR = "hdr"


@dataclass
class Texture:
    data: np.ndarray          # (H, W, C) uint8 or float32
    format: TextureFormat
    name: str = "texture"
    has_alpha: bool = False

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    def as_float_rgba(self) -> np.ndarray:
        """Decode to linear float32 RGBA (H, W, 4) for flattening."""
        d = self.data
        if d.ndim == 2:
            d = d[:, :, None]
        if d.dtype == np.uint8:
            f = d.astype(np.float32) / 255.0
        else:
            f = d.astype(np.float32)
        h, w, c = f.shape
        if c < 4:
            pad = np.ones((h, w, 4 - c), dtype=np.float32)
            if c == 1:
                f = np.repeat(f, 3, axis=2)
            elif c == 2:
                f = np.concatenate([f, np.zeros((h, w, 1), np.float32)], axis=2)
            f = np.concatenate([f, pad[:, :, : 4 - f.shape[2]]], axis=2)
        f = f[:, :, :4]
        if self.format == TextureFormat.SRGB_RGBA:
            rgb = srgb_to_linear(f[:, :, :3])
            f = np.concatenate([rgb, f[:, :, 3:4]], axis=2)
        return np.ascontiguousarray(f, dtype=np.float32)

    def as_u8_rgba(self):
        """(u8 (H, W, 4), srgb: bool) in STORAGE encoding — the atlas keeps
        8-bit texels (4 B/texel instead of 16) and the shader decodes after
        each bilinear tap (decode-then-filter, same math the reference gets
        from Metal's sRGB samplers — texture.cpp:30-48 stores R8/RG8/RGBA8).
        Returns None when the source is float (HDR) and needs the f32 atlas.
        """
        d = self.data
        if d.dtype != np.uint8:
            return None
        if d.ndim == 2:
            d = d[:, :, None]
        h, w, c = d.shape
        if c < 4:
            if c == 1:
                d = np.repeat(d, 3, axis=2)
            elif c == 2:
                d = np.concatenate([d, np.zeros((h, w, 1), np.uint8)], axis=2)
            pad = np.full((h, w, 4 - d.shape[2]), 255, np.uint8)
            d = np.concatenate([d, pad], axis=2)
        return (np.ascontiguousarray(d[:, :, :4]),
                self.format == TextureFormat.SRGB_RGBA)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    c = np.clip(c, 0.0, 1.0)
    return np.where(
        c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1.0 / 2.4) - 0.055
    ).astype(np.float32)


def scan_alpha(data: np.ndarray) -> bool:
    """True if any alpha < 1 (drives stochastic-transparency any-hit)."""
    if data.ndim != 3 or data.shape[2] < 4:
        return False
    a = data[:, :, 3]
    if data.dtype == np.uint8:
        return bool((a < 255).any())
    return bool((a < 1.0).any())
