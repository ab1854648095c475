"""PNG export with an embedded ICC profile, and a PNG reader, without PIL.

Port of platinum_tpu/io/png.py. The JAX package writes and reads PNGs
through Pillow; this package carries its own codec on `zlib` and `struct`
so that its render path needs no imaging library:

- `write_png` quantises as the JAX `write_png` does (`clip * 255 + 0.5`)
  and writes IHDR, one iCCP chunk holding `io.icc.profile_for(space)`
  zlib-compressed, one IDAT of rows under filter 0, and IEND.
- `decode_png` reads 8-bit, non-interlaced PNGs of colour types 0, 2, 3
  (with PLTE and tRNS; palettes of 1, 2, 4 or 8 bits), 4 and 6, undoes the
  five row filters and returns RGBA as Pillow's `Image.convert("RGBA")`
  would.
- `decode_image` is the texture decoder of io/gltf.py: a PNG this module
  reads goes through `decode_png`; any other image (JPEG, 16-bit,
  interlaced, ...) goes to Pillow when it imports, and raises naming the
  image and Pillow when it does not.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from platinum_tpu_torch.io.icc import profile_for

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngUnsupported(ValueError):
    """A valid PNG this codec does not read (16-bit, interlaced, ...)."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, icc: bytes | None = None) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (colour type 2 or 6, filter 0), with
    an iCCP chunk when `icc` is given."""
    img = np.ascontiguousarray(image, np.uint8)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"encode_png takes 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0))
    if icc is not None:
        out += _chunk(b"iCCP", b"ICC Profile\x00\x00" + zlib.compress(icc))
    return (out + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, output_space: str = "sRGB"):
    """image: (H, W, 3|4) uint8 (already display-encoded) or float in [0,1]
    (quantised; assumed already gamma-encoded by the tonemap)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(encode_png(img, profile_for(output_space)))


def chunks(data: bytes):
    """Yield (type, payload) for every chunk of a PNG byte string."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    off = 8
    while off + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, off)
        yield kind, data[off + 8: off + 8 + n]
        off += 12 + n


def icc_profile(data: bytes) -> bytes | None:
    """The ICC profile of a PNG's iCCP chunk, decompressed, or None."""
    for kind, payload in chunks(data):
        if kind == b"iCCP":
            name_end = payload.index(b"\x00")
            return zlib.decompress(payload[name_end + 2:])
    return None


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters of (h, 1 + row_bytes) filtered bytes."""
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    data = raw[:, 1:].astype(np.int32)
    if not (ftype >= 3).any():
        # None, Sub and Up only: each row at once (Sub is a running sum)
        out = np.zeros((h, row_bytes), np.int32)
        prev = np.zeros(row_bytes, np.int32)
        for r in range(h):
            x = data[r]
            if ftype[r] == 1:
                x = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1)
            elif ftype[r] == 2:
                x = x + prev
            prev = out[r] = x & 255
        return out.astype(np.uint8)
    # Average or Paeth present: byte (r, j) needs (r, j - bpp), (r - 1, j)
    # and (r - 1, j - bpp), so every anti-diagonal of pixels is independent
    w = row_bytes // bpp
    px = data.reshape(h, w, bpp)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row and column
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        j = k - r
        a, b, c = out[r + 1, j], out[r, j + 1], out[r, j]
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, j + 1] = (px[r, j] + pred) & 255
    return out[1:, 1:].reshape(h, row_bytes).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, as Image.convert("RGBA")."""
    ihdr = plte = trns = None
    idat = []
    for kind, payload in chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    if interlace or not (depth == 8 or (ctype == 3 and depth in (1, 2, 4))):
        raise PngUnsupported(f"{depth}-bit colour type {ctype}, interlace "
                             f"{interlace}")
    nch = _CHANNELS[ctype]
    row_bytes = -(-w * nch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1)
    px = _unfilter(raw, h, row_bytes, max(1, nch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        px = (bits * weights).sum(-1)[:, :w].astype(np.uint8)
    px = px.reshape(h, w, nch)
    if ctype == 3:
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        idx = px[..., 0]
        return np.concatenate([pal[idx], alpha[idx][..., None]], axis=-1)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if ctype in (0, 4):
        rgba[..., :3] = px[..., :1]
    else:
        rgba[..., :3] = px[..., :3]
    if ctype in (4, 6):
        rgba[..., 3] = px[..., -1]
    elif trns is not None:
        # a single transparent colour: 16-bit samples, the low byte at 8 bits
        key = np.frombuffer(trns, ">u2").astype(np.uint8)
        rgba[..., 3] = np.where((px == key).all(-1), 0, 255)
    return rgba


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """Encoded image bytes -> (H, W, 4) uint8 RGBA. PNGs `decode_png`
    reads need nothing else; every other image needs Pillow."""
    if data[:8] == SIGNATURE:
        try:
            return decode_png(data)
        except PngUnsupported:
            pass
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"image {name!r} is not a PNG that io/png.py reads (8-bit, "
            f"non-interlaced); decoding it needs Pillow, which is not "
            f"installed") from None
    import io as _io

    return np.asarray(Image.open(_io.BytesIO(data)).convert("RGBA"),
                      np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read(), path)
