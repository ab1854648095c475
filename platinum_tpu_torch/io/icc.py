"""Copy of platinum_tpu/io/icc.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

ICC v4 display profile generation (pure Python).

The reference embeds prebuilt sRGB/Display P3 ICC blobs
(the Metal reference's src/utils/icc.{hpp,cpp}, used by the PNG exporter
pt_viewport.cpp:559-615). We *generate* equivalent matrix/parametric-curve
display profiles from chromaticities instead: header + desc/cprt + wtpt +
Bradford-D50-adapted rXYZ/gXYZ/bXYZ colorants + parametric sRGB transfer
curves. Accepted by standard CMMs (little-cms validates these).
"""

from __future__ import annotations

import struct

import numpy as np

from platinum_tpu_torch.core import colorspace as cs

# Bradford cone response matrix
_BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ]
)
_D50 = np.array([0.96422, 1.0, 0.82521])


def _bradford_adapt(src_white_xyz: np.ndarray) -> np.ndarray:
    """3x3 matrix adapting XYZ relative to src white → D50."""
    s = _BRADFORD @ src_white_xyz
    d = _BRADFORD @ _D50
    return np.linalg.inv(_BRADFORD) @ np.diag(d / s) @ _BRADFORD


def _s15f16(x: float) -> bytes:
    return struct.pack(">i", int(round(x * 65536.0)))


def _xyz_tag(xyz) -> bytes:
    return b"XYZ \0\0\0\0" + b"".join(_s15f16(v) for v in xyz)


def _para_srgb_tag() -> bytes:
    # parametricCurveType, function type 3:
    # Y = (aX+b)^g for X >= d, cX otherwise
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    return (
        b"para\0\0\0\0" + struct.pack(">HH", 3, 0)
        + b"".join(_s15f16(v) for v in (g, a, b, c, d))
    )


def _mluc_tag(text: str) -> bytes:
    utf16 = text.encode("utf-16-be")
    return (
        b"mluc\0\0\0\0"
        + struct.pack(">II", 1, 12)
        + b"enUS"
        + struct.pack(">II", len(utf16), 28)
        + utf16
    )


def make_display_profile(colorspace: cs.Colorspace, description: str) -> bytes:
    white_xyz = colorspace.to_xyz @ np.ones(3)
    adapt = _bradford_adapt(white_xyz)
    colorants = adapt @ colorspace.to_xyz  # D50-adapted primaries (columns)

    trc = _para_srgb_tag()
    tags = [
        (b"desc", _mluc_tag(description)),
        (b"cprt", _mluc_tag("public domain")),
        (b"wtpt", _xyz_tag(_D50)),  # media white = D50 (adapted, v4 practice)
        (b"rXYZ", _xyz_tag(colorants[:, 0])),
        (b"gXYZ", _xyz_tag(colorants[:, 1])),
        (b"bXYZ", _xyz_tag(colorants[:, 2])),
        (b"rTRC", trc),
        (b"gTRC", trc),
        (b"bTRC", trc),
    ]

    # Tag table with 4-byte-aligned offsets; shared TRC entries may repeat data
    table_size = 4 + 12 * len(tags)
    header_size = 128
    offset = header_size + table_size
    entries, data = [], b""
    for sig, payload in tags:
        pad = (-len(payload)) % 4
        entries.append((sig, offset, len(payload)))
        data += payload + b"\0" * pad
        offset += len(payload) + pad

    size = header_size + table_size + len(data)
    header = struct.pack(
        ">I4sI4s4s4s",  # size, cmm, version, class, colorspace, pcs
        size, b"ptpu", 0x04300000, b"mntr", b"RGB ", b"XYZ ",
    )
    header += struct.pack(">HHHHHH", 2026, 1, 1, 0, 0, 0)  # dateTime
    header += b"acsp"          # magic
    header += b"\0" * 4        # platform
    header += struct.pack(">I", 0)  # flags
    header += b"\0" * 8        # manufacturer, model
    header += struct.pack(">Q", 0)  # attributes
    header += struct.pack(">I", 0)  # rendering intent: perceptual
    header += _s15f16(_D50[0]) + _s15f16(_D50[1]) + _s15f16(_D50[2])
    header += b"ptpu"          # creator
    header += b"\0" * 16       # profile id
    header += b"\0" * 28       # reserved
    assert len(header) == 128, len(header)

    table = struct.pack(">I", len(tags))
    for sig, off, ln in entries:
        table += sig + struct.pack(">II", off, ln)

    return header + table + data


_CACHE: dict = {}


def profile_for(space: str) -> bytes:
    """ICC blob for an output colorspace name ('sRGB'|'DisplayP3'|'BT2020')."""
    if space not in _CACHE:
        _CACHE[space] = make_display_profile(
            cs.get_colorspace(space), f"platinum-tpu {space}"
        )
    return _CACHE[space]
