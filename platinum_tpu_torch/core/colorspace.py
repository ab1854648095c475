"""Copy of platinum_tpu/core/colorspace.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

RGB colorspace math (host-side, numpy).

Capability parity with the Metal reference's src/core/colorspace.{hpp,cpp}:
a colorspace is defined by the CIE 1931 xy chromaticities of its primaries and
whitepoint; to/from-XYZ matrices are derived by solving for the primary scales
that reproduce the whitepoint (the classic RGB↔XYZ derivation, see
www.ryanjuckett.com/rgb-color-space-conversion). BT.709 / Display P3 / BT.2020
constants, an AgX "inset" colorspace builder, and src→dst transform matrices.

Matrices produced here are baked into render constants and consumed by the
JAX post-processing pipeline as (3, 3) float32 arrays.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

F = np.float32

WHITEPOINT_D65 = (0.3127, 0.3290)


class DisplayColorspace(enum.Enum):
    SRGB = "sRGB"
    DISPLAY_P3 = "DisplayP3"
    BT2020 = "BT2020"


def _xy_to_xyz(xy) -> np.ndarray:
    x, y = float(xy[0]), float(xy[1])
    return np.array([x, y, 1.0 - x - y], dtype=np.float64)


@dataclass(frozen=True)
class Colorspace:
    """An RGB colorspace from primary + whitepoint chromaticities."""

    red: tuple
    green: tuple
    blue: tuple
    whitepoint: tuple = WHITEPOINT_D65

    to_xyz: np.ndarray = field(init=False, repr=False, compare=False)
    from_xyz: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        r, g, b = map(_xy_to_xyz, (self.red, self.green, self.blue))
        w = _xy_to_xyz(self.whitepoint)
        w_xyz = w / w[1]  # whitepoint XYZ with Y = 1

        base = np.stack([r, g, b], axis=1)  # primaries as columns
        scale = np.linalg.solve(base, w_xyz)
        to_xyz = base * scale[None, :]

        object.__setattr__(self, "to_xyz", to_xyz.astype(F))
        object.__setattr__(self, "from_xyz", np.linalg.inv(to_xyz).astype(F))


BT709 = Colorspace((0.640, 0.330), (0.300, 0.600), (0.150, 0.060))
DISPLAY_P3 = Colorspace((0.680, 0.320), (0.265, 0.690), (0.150, 0.060))
BT2020 = Colorspace((0.708, 0.292), (0.170, 0.797), (0.131, 0.046))

_BY_NAME = {
    "sRGB": BT709,
    "BT709": BT709,
    "DisplayP3": DISPLAY_P3,
    "BT2020": BT2020,
}


def get_colorspace(cs) -> Colorspace:
    if isinstance(cs, Colorspace):
        return cs
    if isinstance(cs, DisplayColorspace):
        return _BY_NAME[cs.value]
    return _BY_NAME[str(cs)]


def make_agx_inset(base: Colorspace, compression: float = 0.20) -> Colorspace:
    """AgX 'inset' colorspace: primaries pushed away from the whitepoint so
    the log-space gamut compression in the AgX tonemap has headroom."""
    scale = 1.0 / (1.0 - compression)
    w = np.asarray(base.whitepoint, dtype=np.float64)

    def inset(p):
        p = np.asarray(p, dtype=np.float64)
        return tuple((p - w) * scale + w)

    return Colorspace(inset(base.red), inset(base.green), inset(base.blue), tuple(w))


def transform(src: Colorspace, dst: Colorspace) -> np.ndarray:
    """(3, 3) matrix converting linear RGB in `src` to linear RGB in `dst`."""
    return (dst.from_xyz @ src.to_xyz).astype(F)


def luminance_weights(cs: Colorspace) -> np.ndarray:
    """Per-channel luminance weights (the Y row of to_xyz)."""
    return cs.to_xyz[1].astype(F)
