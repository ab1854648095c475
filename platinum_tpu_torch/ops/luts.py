"""GGX energy-compensation LUTs: loading and clamp-to-edge sampling.

Torch counterpart of platinum_tpu/ops/luts.py. The tables come from the
port's copy of the same bundle (platinum_tpu_torch/resources/ggx_luts.npz,
a copy of platinum_tpu/resources/ggx_luts.npz, chosen exactly as the JAX
package's `_bundle_path` chooses it); the two coat tables are computed at
load by the same deterministic quadrature. `get_host_luts()` returns the
numpy view the flattener bakes per-material energy rows from;
`load_luts(device)` returns the tensors the BSDF samples at shading time.
Sampling reproduces Metal's normalized-coordinate clamp-to-edge linear
filtering (texel centers at (i+0.5)/N), in the JAX package's op order.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from platinum_tpu_torch.render.types import TensorStruct

RESOURCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources")
LUT_BUNDLE = os.path.join(RESOURCE_DIR, "ggx_luts.npz")
LUT_BUNDLE_REF = os.path.join(RESOURCE_DIR, "ggx_luts_ref.npz")

LUT_NAMES = (
    "E", "E_avg", "E_ms", "E_ms_avg",
    "E_trans_in", "E_trans_out", "E_trans_in_avg", "E_trans_out_avg",
    "E_aniso", "E_avg_aniso", "E_ms_aniso", "E_ms_avg_aniso",
)


@dataclass(frozen=True)
class Luts(TensorStruct):
    """The LUT set; field meanings as in the JAX package's Luts. Leaves
    are numpy arrays in the host view and tensors in the device view."""

    E: object
    E_avg: object
    E_ms: object
    E_ms_avg: object
    E_trans_in: object
    E_trans_out: object
    E_trans_in_avg: object
    E_trans_out_avg: object
    E_aniso: object
    E_avg_aniso: object
    E_ms_aniso: object
    E_ms_avg_aniso: object
    F_coat_avg: object
    E_F_coat: object


def _bundle_arrays(data) -> dict:
    """Bundle .npz -> {name: float32 array}, with the singleton-axis
    fallbacks for bundles baked before the anisotropic tables existed."""
    out = {k: np.asarray(data[k], np.float32)
           for k in LUT_NAMES if k in data}
    if "E_aniso" not in out:
        out["E_aniso"] = out["E"][None]
    if "E_avg_aniso" not in out:
        out["E_avg_aniso"] = out["E_avg"][:, None]
    if "E_ms_aniso" not in out and "E_ms" in out:
        out["E_ms_aniso"] = out["E_ms"][None]
    if "E_ms_avg_aniso" not in out and "E_ms_avg" in out:
        out["E_ms_avg_aniso"] = out["E_ms_avg"][None]
    return out


def _bake_coat_fresnel_avg(n_rough: int = 32, n_cos: int = 32,
                           n_quad: int = 64, ior: float = 1.5):
    """Mean coat Fresnel F̄ and Fresnel-weighted coat albedo E_F over the
    spherical-cap VNDF warp, by n_quad² midpoint quadrature in float64
    (the JAX package's `_bake_coat_fresnel_avg`, same arithmetic)."""
    r = (np.arange(n_rough, dtype=np.float64) + 0.5) / n_rough
    c = (np.arange(n_cos, dtype=np.float64) + 0.5) / n_cos
    rough, cos_o = np.meshgrid(r, c, indexing="ij")
    alpha = np.maximum(rough * rough, 1e-4)[..., None]
    sin_o = np.sqrt(np.maximum(0.0, 1.0 - cos_o * cos_o))[..., None]
    cos_o = cos_o[..., None]

    u = (np.arange(n_quad, dtype=np.float64) + 0.5) / n_quad
    u1, u2 = np.meshgrid(u, u, indexing="ij")
    u1, u2 = u1.ravel(), u2.ravel()

    whx, whz = alpha * sin_o, np.broadcast_to(cos_o, alpha.shape).copy()
    n = np.sqrt(whx * whx + whz * whz)
    whx, whz = whx / n, whz / n
    alpha2 = alpha * alpha
    mix = 0.5 * whz + 0.5

    def lam(z):
        z2 = np.maximum(z * z, 1e-20)
        return (np.sqrt(1.0 + alpha2 * (1.0 - z2) / z2) - 1.0) * 0.5

    f_sum = np.zeros(alpha.shape[:2])
    fw_sum = np.zeros(alpha.shape[:2])
    q_total = u1.size
    for lo in range(0, q_total, 512):
        u1c, u2c = u1[lo:lo + 512], u2[lo:lo + 512]
        pr = np.sqrt(u1c)
        px = pr * np.cos(2.0 * np.pi * u2c)
        py_raw = pr * np.sin(2.0 * np.pi * u2c)
        h = np.sqrt(np.maximum(0.0, 1.0 - px * px))
        py = h * (1.0 - mix) + py_raw * mix
        pz = np.sqrt(np.maximum(0.0, 1.0 - px * px - py * py))
        nhx = -whz * py + whx * pz
        nhz = whx * py + whz * pz
        wmx, wmy, wmz = alpha * nhx, alpha * px, np.maximum(1e-6, nhz)
        n = np.sqrt(wmx * wmx + wmy * wmy + wmz * wmz)
        cos_wm = np.clip((sin_o * wmx + cos_o * wmz) / n, 0.0, 1.0)

        sin2_t = (1.0 - cos_wm * cos_wm) / (ior * ior)
        cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin2_t))
        par = (ior * cos_wm - cos_t) / np.maximum(ior * cos_wm + cos_t, 1e-20)
        per = (cos_wm - ior * cos_t) / np.maximum(cos_wm + ior * cos_t, 1e-20)
        f = 0.5 * (par * par + per * per)
        f = np.where(sin2_t >= 1.0, 1.0, f)

        wmx_n, wmz_n = wmx / n, wmz / n
        wiz = 2.0 * (sin_o * wmx_n + cos_o * wmz_n) * wmz_n - cos_o
        w_vndf = np.where(
            wiz > 0.0,
            (1.0 + lam(cos_o)) / (1.0 + lam(cos_o) + lam(wiz)),
            0.0,
        )
        f_sum += f.sum(axis=-1)
        fw_sum += (f * w_vndf).sum(axis=-1)
    return ((f_sum / q_total).astype(np.float32),
            (fw_sum / q_total).astype(np.float32))


def _bundle_path() -> str:
    """The bundle the JAX package's `_bundle_path` picks: the self-baked
    one unless PLATINUM_TPU_LUTS names another (see that function)."""
    env = os.environ.get("PLATINUM_TPU_LUTS", "").strip()
    path = LUT_BUNDLE
    if env and env != "own":
        path = LUT_BUNDLE_REF if env == "ref" else env
    if not os.path.exists(path):
        raise FileNotFoundError(f"GGX LUT bundle not found: {path}")
    return path


_HOST_CACHE: dict = {}


def get_host_luts() -> Luts:
    """Numpy LUT set for flatten-time baking, cached per bundle path."""
    path = _bundle_path()
    if path not in _HOST_CACHE:
        f_coat, e_f = _bake_coat_fresnel_avg()
        _HOST_CACHE[path] = Luts(**_bundle_arrays(np.load(path)),
                                 F_coat_avg=f_coat, E_F_coat=e_f)
    return _HOST_CACHE[path]


def load_luts(device) -> Luts:
    """Tensor LUT set on `device` (same bundle as get_host_luts)."""
    host = get_host_luts()
    return Luts(**{f.name: torch.from_numpy(getattr(host, f.name)).to(device)
                   for f in dataclasses.fields(host)})


# ---------------------------------------------------------------------------
# Metal-style normalized clamp-to-edge linear sampling
# ---------------------------------------------------------------------------

def _axis(coord, n):
    x = torch.clamp(coord * n - 0.5, 0.0, n - 1.0)
    x0 = torch.floor(x)
    f = x - x0
    i0 = x0.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, f


def sample1d(lut, u):
    (n,) = lut.shape
    i0, i1, f = _axis(u, n)
    return lut[i0] * (1 - f) + lut[i1] * f


def sample2d(lut, u, v):
    """lut is (H, W) indexed [v, u]."""
    h, w = lut.shape
    x0, x1, fx = _axis(u, w)
    y0, y1, fy = _axis(v, h)
    return (
        (lut[y0, x0] * (1 - fx) + lut[y0, x1] * fx) * (1 - fy)
        + (lut[y1, x0] * (1 - fx) + lut[y1, x1] * fx) * fy
    )


def sample3d(lut, u, v, w_):
    """lut is (D, H, W) indexed [w, v, u]."""
    d, h, w = lut.shape
    x0, x1, fx = _axis(u, w)
    y0, y1, fy = _axis(v, h)
    z0, z1, fz = _axis(w_, d)

    def bil(z):
        return (
            (lut[z, y0, x0] * (1 - fx) + lut[z, y0, x1] * fx) * (1 - fy)
            + (lut[z, y1, x0] * (1 - fx) + lut[z, y1, x1] * fx) * fy
        )

    return bil(z0) * (1 - fz) + bil(z1) * fz


def sample4d(lut, u, v, w_, q):
    """lut is (Q, D, H, W) indexed [q, w, v, u]."""
    qn, d, h, w = lut.shape
    x0, x1, fx = _axis(u, w)
    y0, y1, fy = _axis(v, h)
    z0, z1, fz = _axis(w_, d)
    a0, a1, fa = _axis(q, qn)

    def tri(a):
        def bil(z):
            return (
                (lut[a, z, y0, x0] * (1 - fx) + lut[a, z, y0, x1] * fx) * (1 - fy)
                + (lut[a, z, y1, x0] * (1 - fx) + lut[a, z, y1, x1] * fx) * fy
            )

        return bil(z0) * (1 - fz) + bil(z1) * fz

    return tri(a0) * (1 - fa) + tri(a1) * fa


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) mirrors used by the flattener to bake the
# per-material energy rows — the JAX package's *_np helpers
# ---------------------------------------------------------------------------

def _axis_np(coord, n):
    x = np.clip(np.asarray(coord, np.float64) * n - 0.5, 0.0, n - 1.0)
    x0 = np.floor(x)
    return x0.astype(np.int64), np.minimum(x0 + 1, n - 1).astype(np.int64), x - x0


def sample1d_np(lut, u):
    lut = np.asarray(lut)
    i0, i1, f = _axis_np(u, lut.shape[0])
    return lut[i0] * (1 - f) + lut[i1] * f


def sample2d_np(lut, u, v):
    lut = np.asarray(lut)
    h, w = lut.shape
    x0, x1, fx = _axis_np(u, w)
    y0, y1, fy = _axis_np(v, h)
    return ((lut[y0, x0] * (1 - fx) + lut[y0, x1] * fx) * (1 - fy)
            + (lut[y1, x0] * (1 - fx) + lut[y1, x1] * fx) * fy)


def sample3d_np(lut, u, v, w_):
    lut = np.asarray(lut)
    d, h, w = lut.shape
    x0, x1, fx = _axis_np(u, w)
    y0, y1, fy = _axis_np(v, h)
    z0, z1, fz = _axis_np(w_, d)

    def bil(z):
        return ((lut[z, y0, x0] * (1 - fx) + lut[z, y0, x1] * fx) * (1 - fy)
                + (lut[z, y1, x0] * (1 - fx) + lut[z, y1, x1] * fx) * fy)

    return bil(z0) * (1 - fz) + bil(z1) * fz


def sample4d_np(lut, u, v, w_, q):
    """`q` must be a scalar (the flattener's per-material anisotropy)."""
    lut = np.asarray(lut)
    qn = lut.shape[0]
    a0, a1, fa = _axis_np(q, qn)
    return sample3d_np(lut[a0], u, v, w_) * (1 - fa) + sample3d_np(
        lut[a1], u, v, w_) * fa
