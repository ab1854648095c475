"""Copy of platinum_tpu/tools/import_luts.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Assemble the GGX energy-LUT bundle (.npz) from a directory of EXR slices.

The reference ships its LUT set as 101 EXR files (one per 2D slice; 3D LUTs
as 32 z-slices — resource/lut/, loaded at renderer_pt.cpp:385-446, table at
renderer_pt.hpp:154-165). SURVEY §2.7 sanctions loading these exact files
for bit-comparable energy compensation, which removes the ~1% Monte-Carlo
rebake noise floor from the furnace/golden error budget. This tool converts
any such directory (the reference's, or this repo's own `bake-luts` output)
into the single .npz bundle `ops/luts.py` loads.

Usage: python -m platinum_tpu_torch.tools.import_luts SRC_DIR [OUT_NPZ]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from platinum_tpu_torch.io.exr import read_exr
from platinum_tpu_torch.ops.luts import LUT_BUNDLE


def _slice(path: str) -> np.ndarray:
    """Read one EXR as a 2D float32 array (first channel)."""
    img = read_exr(path)
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img[..., 0]
    return img


def import_lut_dir(src_dir: str, out_path: str | None = None) -> dict:
    """Build the 8-LUT bundle from `src_dir` and write it to `out_path`."""
    def p(name):
        return os.path.join(src_dir, name + ".exr")

    def vol(name, depth=32):
        return np.stack([_slice(p(f"{name}_{z}")) for z in range(depth)])

    luts = dict(
        E=_slice(p("ggx_E")),
        E_avg=_slice(p("ggx_E_avg")).reshape(-1),
        E_ms=vol("ggx_ms_E"),
        E_ms_avg=_slice(p("ggx_ms_E_avg")),
        E_trans_in=vol("ggx_E_trans_in"),
        E_trans_out=vol("ggx_E_trans_out"),
        E_trans_in_avg=_slice(p("ggx_E_trans_in_avg")),
        E_trans_out_avg=_slice(p("ggx_E_trans_out_avg")),
    )
    assert luts["E"].shape == (128, 128) and luts["E_avg"].shape == (128,)
    assert luts["E_ms"].shape == (32, 32, 32)
    out_path = out_path or LUT_BUNDLE
    np.savez_compressed(out_path, **luts)
    return luts


if __name__ == "__main__":
    src = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else None
    luts = import_lut_dir(src, out)
    for k, v in luts.items():
        print(k, v.shape, float(v.min()), float(v.max()))
