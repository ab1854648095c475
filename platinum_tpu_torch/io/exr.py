"""Copy of platinum_tpu/io/exr.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Minimal OpenEXR 2.0 scanline codec (pure Python + numpy + zlib).

Replaces the reference's tinyexr dependency (LUT loads renderer_pt.cpp:385-446
and EXR export). Supports what this framework needs:

  read:  single-part scanline images, NONE / ZIPS / ZIP compression,
         half & float channels, increasing or decreasing line order.
  write: NONE or ZIP compression, float32 or float16 channels, RGB(A)/Y.

The ZIP predictor+interleave scheme follows the OpenEXR format spec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
_PT_SIZES = {0: 4, 1: 2, 2: 4}  # uint, half, float
_PT_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}


def _unpredict(data: bytes) -> bytes:
    delta = np.frombuffer(data, np.uint8).astype(np.int64)
    delta[1:] -= 128  # d[i] += d[i-1] - 128, d[0] unchanged
    arr = (np.cumsum(delta) % 256).astype(np.uint8)
    # de-interleave: first half → even positions, second half → odd
    n = len(arr)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16)
    d = ((d + 128) % 256).astype(np.uint8)
    d[0] = inter[0]
    # first byte stays as-is: encoder stores t[0], deltas after
    return d.tobytes()


def _read_attrs(buf: bytes, off: int):
    attrs = {}
    while True:
        end = buf.index(b"\0", off)
        name = buf[off:end].decode()
        off = end + 1
        if not name:
            break
        end = buf.index(b"\0", off)
        typ = buf[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = (typ, buf[off : off + size])
        off += size
    return attrs, off


def _parse_chlist(val: bytes):
    chans = []
    off = 0
    while val[off] != 0:
        end = val.index(b"\0", off)
        name = val[off:end].decode()
        off = end + 1
        ptype, _flags, _xs, _ys = struct.unpack_from("<iiii", val, off)
        off += 16
        chans.append((name, ptype))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Returns (H, W, C) float32. Channel order: R,G,B[,A] when present,
    otherwise the file's alphabetical order (e.g. Y → C=1)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")

    attrs, off = _read_attrs(buf, 8)
    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    width = x1 - x0 + 1
    height = y1 - y0 + 1

    if comp == 0:
        lines_per_block = 1
    elif comp in (2, 3):  # ZIPS, ZIP
        lines_per_block = 1 if comp == 2 else 16
    else:
        raise NotImplementedError(f"EXR compression {comp} not supported")

    n_blocks = -(-height // lines_per_block)
    off += n_blocks * 8  # skip the offset table; blocks follow sequentially

    out = {name: np.zeros((height, width), np.float32) for name, _ in chans}
    bytes_per_line = sum(_PT_SIZES[pt] for _, pt in chans) * width

    pos = off
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        raw = buf[pos : pos + size]
        pos += size
        ny = min(lines_per_block, y1 - y + 1)
        expect = bytes_per_line * ny
        if comp != 0:
            if size < expect:
                raw = _unpredict(zlib.decompress(raw))
            # (openexr stores raw when compression doesn't help)
        data = np.frombuffer(raw, np.uint8)
        row_off = 0
        for line in range(ny):
            for name, pt in chans:  # per line: channels in list order
                cnt = width * _PT_SIZES[pt]
                chunk = data[row_off : row_off + cnt]
                vals = np.frombuffer(chunk.tobytes(), _PT_DTYPES[pt])
                out[name][y - y0 + line] = vals.astype(np.float32)
                row_off += cnt
    names = [c[0] for c in chans]
    if all(c in names for c in "RGB"):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path: str, image: np.ndarray, compression: str = "zip",
              half: bool = False):
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) float image."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    # map channel name → source index in RGB(A) input
    src = {"R": 0, "G": 1, "B": 2, "A": 3, "Y": 0}
    ptype = 1 if half else 2
    dtype = np.float16 if half else np.float32
    psize = _PT_SIZES[ptype]

    comp_id = {"none": 0, "zip": 3, "zips": 2}[compression]
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp_id]

    def attr(name, typ, val):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(val)) + val

    chlist = b""
    for n in names:  # alphabetical already
        chlist += n.encode() + b"\0" + struct.pack("<iiii", ptype, 0, 1, 1)
    chlist += b"\0"

    header = struct.pack("<ii", MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([comp_id]))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    n_blocks = -(-h // lines_per_block)
    blocks = []
    for b in range(n_blocks):
        y = b * lines_per_block
        ny = min(lines_per_block, h - y)
        rows = []
        for line in range(ny):
            for n in names:
                rows.append(img[y + line, :, src[n]].astype(dtype).tobytes())
        raw = b"".join(rows)
        if comp_id != 0:
            packed = zlib.compress(_predict(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        blocks.append((y, packed))

    with open(path, "wb") as fh:
        fh.write(header)
        table_pos = len(header)
        data_pos = table_pos + 8 * n_blocks
        offsets = []
        cursor = data_pos
        for y, packed in blocks:
            offsets.append(cursor)
            cursor += 8 + len(packed)
        fh.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for y, packed in blocks:
            fh.write(struct.pack("<ii", y, len(packed)))
            fh.write(packed)
