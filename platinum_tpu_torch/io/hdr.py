"""Copy of platinum_tpu/io/hdr.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Radiance RGBE (.hdr) image reader/writer (pure numpy).

The reference decodes .hdr environment maps with stb_image
(loaders/texture.cpp HDR path); this is the standalone equivalent: the
RADIANCE format's shared-exponent RGBE pixels, supporting both flat and
new-style RLE-compressed scanlines.
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) u8 RGBE -> (..., 3) f32 linear radiance."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - (128.0 + 8.0)), 0.0)
    return rgbe[..., :3] * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) f32 -> (..., 4) u8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    e = np.zeros_like(maxc, np.int32)
    nz = maxc >= 1e-32
    e[nz] = np.frexp(maxc[nz])[1]
    scale = np.where(nz, np.exp2(-(e.astype(np.float32))) * 256.0, 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) f32 linear."""
    with open(path, "rb") as f:
        raw = f.read()
    if not (raw.startswith(b"#?RADIANCE") or raw.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header: lines until blank, then the resolution line
    pos = raw.index(b"\n") + 1
    fmt = None
    while True:
        end = raw.index(b"\n", pos)
        line = raw[pos:end]
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1].strip()
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise ValueError(f"{path}: unsupported FORMAT {fmt!r}")
    end = raw.index(b"\n", pos)
    res = raw[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {b' '.join(res)!r}")
    h, w = int(res[1]), int(res[3])

    data = np.frombuffer(raw, np.uint8, offset=pos)
    img = np.zeros((h, w, 4), np.uint8)
    di = 0
    for y in range(h):
        if (w < 8 or w > 0x7FFF or data[di] != 2 or data[di + 1] != 2
                or (int(data[di + 2]) << 8 | int(data[di + 3])) != w):
            # flat (or old-style RLE) scanline: w RGBE pixels verbatim.
            # Old-style (1,1,1,n) run markers are rare; reject clearly.
            row = data[di:di + w * 4]
            if len(row) < w * 4:
                raise ValueError(f"{path}: truncated scanline {y}")
            rr = row.reshape(w, 4)
            # old-style run marker: a pixel with r==g==b==1 (exponent byte
            # is the repeat count) — must be all three IN THE SAME pixel
            if ((rr[:, 0] == 1) & (rr[:, 1] == 1) & (rr[:, 2] == 1)).any():
                raise ValueError(f"{path}: old-style RLE not supported")
            img[y] = rr
            di += w * 4
            continue
        di += 4
        for c in range(4):   # new-style RLE: per-channel runs
            x = 0
            while x < w:
                n = int(data[di])
                di += 1
                if n > 128:          # run of the same byte
                    img[y, x:x + n - 128, c] = data[di]
                    di += 1
                    x += n - 128
                else:                # literal bytes
                    img[y, x:x + n, c] = data[di:di + n]
                    di += n
                    x += n
    return _rgbe_to_float(img)


def write_hdr(path: str, rgb: np.ndarray):
    """Write (H, W, 3) f32 linear as .hdr. Widths 8..32767 use new-style
    per-channel scanlines (all-literal runs): a FLAT row whose first pixel
    happens to encode as RGBE (2, 2, w>>8, w&255) would be misparsed as an
    RLE header by any conforming reader (stb included), so like stb we
    only emit flat rows outside the RLE-able width range."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    rgbe = _float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if not (8 <= w <= 0x7FFF):
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                col = rgbe[y, :, c].tobytes()
                for x0 in range(0, w, 128):
                    chunk = col[x0:x0 + 128]
                    f.write(bytes([len(chunk)]) + chunk)
