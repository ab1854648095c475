"""GGX energy LUT baker (torch Monte Carlo).

Port of platinum_tpu/tools/lut_baker.py: tabulates the Kulla-Conty /
Turquin energy LUTs by VNDF importance sampling, vectorised over every
texel at once (the reference tool's ms_lut_gen.{cpp,metal} rework).
Integrands as there (ms_lut_gen.metal:225-336):

  E            mean[ f_ss · |wi.z| / pdf ]            (pure GGX, no Fresnel)
  E_avg        mean[ 2 · f_ss · |wi.z| · μo / pdf ],  μo ~ U(0,1)
  E_ms         mean over Fresnel-weighted (single + Kulla-Conty ms) dielectric
  E_trans_in/out  full transparent dielectric with Fresnel-split refl/refr
                  (η = 1/(1−p) entering, η = 1−p exiting)
  E_aniso, E_avg_aniso, E_ms_aniso, E_ms_avg_aniso: the azimuth-averaged
                  anisotropic tables

`_mc` batches as the JAX module does: `samples_per_call` samples of every
texel in one pass (~4M lanes a batch unless a bake sets its own count),
PCG4D streams keyed by (texel index & 0xFFFF, texel index >> 16, sample
index), so every sample draws the JAX package's numbers bit for bit. Each
batch is summed over its samples in float32 and the sums accumulate in
float64 (on the bake's device: the same IEEE adds as JAX's host numpy
accumulator, without a host sync a batch).

It is pure JAX in the reference (no Pallas kernel), so it is torch ops
here. Every bake runs on `device`: the card unless given the CPU, as the
Renderer does; without a card it raises. `bake_all` writes the port's own
bundle (ops/luts.LUT_BUNDLE) and, with `write_exr_slices`, the EXR slices
under the port's RESOURCE_DIR/lut.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from platinum_tpu_torch.models import fresnel, ggx
from platinum_tpu_torch.ops.frame import dot
from platinum_tpu_torch.ops.luts import (LUT_BUNDLE, RESOURCE_DIR, sample1d,
                                         sample2d, sample3d)
from platinum_tpu_torch.ops.samplers import MASK32, PCG4DStream
from platinum_tpu_torch.render.types import resolve_device


def _wo_from_cos(cos_theta):
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([sin_theta, torch.zeros_like(cos_theta), cos_theta],
                       dim=-1)


def _azimuth_wo(sin_t, cos_t, uphi):
    """(sin θ cos φ, sin θ sin φ, cos θ) with φ = 2π uphi."""
    phi = 2.0 * np.pi * uphi
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        torch.broadcast_to(cos_t, phi.shape)], dim=-1)


def _sample_single_scatter(alpha, wo, u2):
    """f, wi, pdf of the pure GGX BRDF (ms_lut_gen.metal:231-246)."""
    wm = ggx.sample_vmdf(alpha, wo, u2)
    wi = ggx.reflect(-wo, wm)
    bad = (wm[..., 2] <= 0.0) | (wo[..., 2] * wi[..., 2] < 0.0)
    f = torch.where(bad, 0.0, ggx.single_scatter_brdf(alpha, wo, wi, wm))
    pdf = torch.where(bad, 1.0, ggx.pdf(alpha, wo, wm))
    return f, wi, pdf


def _ms_terms(ior, e_wo, e_wi, e_avg):
    """Kulla-Conty multiscatter BRDF and its Fresnel weight."""
    f_avg = fresnel.avg_dielectric_fresnel_fit(ior)
    brdf_ms = (1.0 - e_wo) * (1.0 - e_wi) / (
        np.pi * torch.clamp(1.0 - e_avg, min=1e-5))
    fresnel_ms = f_avg * f_avg * e_avg / torch.clamp(
        1.0 - f_avg * (1.0 - e_avg), min=1e-5)
    return brdf_ms, fresnel_ms


def _sample_ms_dielectric(alpha, rough, ior, wo, u2, lut_e, lut_eavg):
    """Fresnel-weighted single + Kulla-Conty multiscatter dielectric
    (ms_lut_gen.metal:251-281)."""
    wm = ggx.sample_vmdf(alpha, wo, u2)
    wi = ggx.reflect(-wo, wm)
    bad = wo[..., 2] * wi[..., 2] < 0.0

    brdf_ss = ggx.single_scatter_brdf(alpha, wo, wi, wm)
    f_ss = fresnel.fresnel_dielectric(torch.abs(dot(wo, wm)), ior)
    e_wo = sample2d(lut_e, wo[..., 2], rough)
    e_wi = sample2d(lut_e, wi[..., 2], rough)
    e_avg = sample1d(lut_eavg, rough)
    brdf_ms, fresnel_ms = _ms_terms(ior, e_wo, e_wi, e_avg)

    f = torch.where(bad, 0.0, f_ss * brdf_ss + fresnel_ms * brdf_ms)
    pdf = torch.where(bad, 1.0, ggx.pdf(alpha, wo, wm))
    return f, wi, pdf


def _sample_transparent(alpha, ior, wo, u3):
    """Transparent dielectric with Fresnel-split reflect/refract
    (ms_lut_gen.metal:285-331)."""
    wm = ggx.sample_vmdf(alpha, wo, u3[..., :2])
    f_ss = fresnel.fresnel_dielectric(torch.abs(dot(wo, wm)), ior)
    reflecting = u3[..., 2] < f_ss

    wi_r = ggx.reflect(-wo, wm)
    wm_signed = wm * torch.where(dot(wo, wm)[..., None] < 0, -1.0, 1.0)
    wi_t = ggx.refract(-wo, wm_signed, 1.0 / ior)
    wi = torch.where(reflecting[..., None], wi_r, wi_t)

    same_side = wo[..., 2] * wi[..., 2] > 0.0
    bad = torch.where(reflecting, ~same_side, same_side)

    # reflection branch
    f_refl = ggx.single_scatter_brdf(alpha, wo, wi, wm)
    pdf_refl = ggx.pdf(alpha, wo, wm)
    # refraction branch
    dot_i = dot(wi, wm)
    dot_o = dot(wo, wm)
    denom = (dot_i * ior + dot_o) ** 2
    dwm_dwi = torch.abs(dot_i) / torch.clamp(denom, min=1e-20)
    f_refr = (ggx.mdf(alpha, wm) * ggx.g(alpha, wo, wi)
              * torch.abs(dot_i * dot_o / (wi[..., 2] * wo[..., 2]
                                           * torch.clamp(denom, min=1e-20))))
    pdf_refr = ggx.vmdf(alpha, wo, wm) * dwm_dwi

    k = torch.where(reflecting, f_ss, 1.0 - f_ss)
    f = k * torch.where(reflecting, f_refl, f_refr)
    pdf = k * torch.where(reflecting, pdf_refl, pdf_refr)
    f = torch.where(bad, 0.0, f)
    pdf = torch.where(bad, 1.0, pdf)
    return f, wi, pdf


def _mc(texel_fn, shape, spp, device, samples_per_call=None, seed_base=0):
    """Mean of texel_fn(stream) over spp samples of every texel: batches
    of `samples_per_call` samples (JAX lut_baker.py:117-146's count and
    streams), each a (k, n_texels) pass whose texel parameters broadcast
    against the leading sample axis."""
    n = int(np.prod(shape))
    if samples_per_call is None:
        samples_per_call = max(64, int(2 ** np.floor(np.log2(4e6 / n))))
    k = min(samples_per_call, spp)
    if spp % k != 0:
        raise ValueError(f"spp={spp} is not a multiple of the batch {k}")
    lin = torch.arange(n, dtype=torch.int64, device=device)
    px = torch.broadcast_to(lin & 0xFFFF, (k, n))
    py = torch.broadcast_to(lin >> 16, (k, n))
    ks = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    acc = torch.zeros(n, dtype=torch.float64, device=device)
    for s0 in range(0, spp, k):
        s = torch.broadcast_to((s0 + seed_base + ks) & MASK32, (k, n))
        stream = PCG4DStream.create(px, py, s)
        acc += torch.sum(texel_fn(stream), dim=0).double()
    return (acc / spp).reshape(shape).to(torch.float32).cpu().numpy()


def _grid(shape):
    """Texel-centre coordinates (i + 0.5) / n of every axis of `shape`,
    each flattened over the whole grid (float32 numpy, as the JAX module
    forms them)."""
    idx = np.indices(shape).astype(np.float32)
    return [((g + 0.5) / n).reshape(-1) for g, n in zip(idx, shape)]


def _ior(iorp, out: bool):
    """η from the ior parameter p: 1 − p exiting, 1/(1 − p) entering."""
    return (1.0 - iorp) if out else 1.0 / (1.0 - iorp)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def bake_E(size=128, spp=4096, *, device="cuda"):
    dev = resolve_device(device)
    rough, cos_t = _on(dev, *_grid((size, size)))
    alpha = ggx.alpha_from_roughness(rough)
    wo = _wo_from_cos(cos_t)

    def texel(stream):
        _, u2 = stream.next_2d()
        f, wi, pdf = _sample_single_scatter(alpha, wo, u2)
        v = f * torch.abs(wi[..., 2]) / pdf
        # corner-texel fudge kept for parity (ms_lut_gen.metal:375-377)
        corner = (rough < 2.0 / 32.0) & (cos_t < 1.0 / 32.0)
        return torch.where(corner, v * 0.961, v)

    return _mc(texel, (size, size), spp, dev)


def bake_E_avg(size=128, spp=16384, *, device="cuda"):
    dev = resolve_device(device)
    (rough,) = _on(dev, *_grid((size,)))
    alpha = ggx.alpha_from_roughness(rough)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, u1 = stream.next_1d()
        wo = _wo_from_cos(u1)
        f, wi, pdf = _sample_single_scatter(alpha, wo, u2)
        return 2.0 * f * torch.abs(wi[..., 2]) * wo[..., 2] / pdf

    return _mc(texel, (size,), spp, dev)


def bake_E_aniso(size=32, spp=8192, *, device="cuda"):
    """Azimuth-averaged directional albedo of ANISOTROPIC GGX,
    E̅(aniso, rough, cosθ) (JAX lut_baker.py:179-208: alpha stretched by
    aspect = sqrt(1 − 0.9·aniso); by x/y-swap symmetry |aniso| suffices;
    no corner fudge)."""
    dev = resolve_device(device)
    aniso, rough, cos_t = _on(dev, *_grid((size, size, size)))
    alpha = ggx.alpha_from_roughness(rough, aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, uphi = stream.next_1d()
        wo = _azimuth_wo(sin_t, cos_t, uphi)
        f, wi, pdf = _sample_single_scatter(alpha, wo, u2)
        return f * torch.abs(wi[..., 2]) / pdf

    return _mc(texel, (size, size, size), spp, dev)


def _sample_ms_dielectric_aniso(alpha, rough, aniso, ior, wo, u2,
                                lut_e_aniso, lut_eavg_aniso):
    """The anisotropic _sample_ms_dielectric: the stretched GGX lobe and
    the Kulla-Conty energy lookups from the azimuth-averaged aniso tables
    (the terms the runtime's dielectric specular evaluates)."""
    wm = ggx.sample_vmdf(alpha, wo, u2)
    wi = ggx.reflect(-wo, wm)
    bad = wo[..., 2] * wi[..., 2] < 0.0

    brdf_ss = ggx.single_scatter_brdf(alpha, wo, wi, wm)
    f_ss = fresnel.fresnel_dielectric(torch.abs(dot(wo, wm)), ior)
    e_wo = sample3d(lut_e_aniso, wo[..., 2], rough, aniso)
    e_wi = sample3d(lut_e_aniso, torch.abs(wi[..., 2]), rough, aniso)
    e_avg = sample2d(lut_eavg_aniso, aniso, rough)
    brdf_ms, fresnel_ms = _ms_terms(ior, e_wo, e_wi, e_avg)

    f = torch.where(bad, 0.0, f_ss * brdf_ss + fresnel_ms * brdf_ms)
    pdf = torch.where(bad, 1.0, ggx.pdf(alpha, wo, wm))
    return f, wi, pdf


def bake_E_ms_aniso(lut_e_aniso, lut_eavg_aniso, size=32, asize=8,
                    spp=2048, *, device="cuda"):
    """Azimuth-averaged anisotropic Fresnel-weighted multiscatter
    dielectric albedo E_ms(|aniso|, iorParam, rough, cosθ), 8 aniso bins
    (JAX lut_baker.py:238-274)."""
    dev = resolve_device(device)
    aniso, iorp, rough, cos_t = _grid((asize, size, size, size))
    aniso, ior, rough, cos_t = _on(dev, aniso, _ior(iorp, False), rough,
                                   cos_t)
    alpha = ggx.alpha_from_roughness(rough, aniso)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    lut_e_aniso = torch.as_tensor(lut_e_aniso, device=dev)
    lut_eavg_aniso = torch.as_tensor(lut_eavg_aniso, device=dev)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, uphi = stream.next_1d()
        wo = _azimuth_wo(sin_t, cos_t, uphi)
        f, wi, pdf = _sample_ms_dielectric_aniso(
            alpha, rough, aniso, ior, wo, u2, lut_e_aniso, lut_eavg_aniso)
        return f * torch.abs(wi[..., 2]) / pdf

    # the JAX module caps the batch at 8 samples: the texel count is
    # already 0.5M, so the default would be forced to the 64 floor
    return _mc(texel, (asize, size, size, size), spp, dev,
               samples_per_call=8)


def bake_E_ms_avg_aniso(lut_e_aniso, lut_eavg_aniso, size=32, asize=8,
                        spp=16384, *, device="cuda"):
    """Cosine-weighted hemispherical average of bake_E_ms_aniso:
    E_ms_avg(|aniso|, rough, iorParam)."""
    dev = resolve_device(device)
    aniso, rough, iorp = _grid((asize, size, size))
    aniso, rough, ior = _on(dev, aniso, rough, _ior(iorp, False))
    alpha = ggx.alpha_from_roughness(rough, aniso)
    lut_e_aniso = torch.as_tensor(lut_e_aniso, device=dev)
    lut_eavg_aniso = torch.as_tensor(lut_eavg_aniso, device=dev)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, u1 = stream.next_1d()
        stream, uphi = stream.next_1d()
        sin_t = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
        wo = _azimuth_wo(sin_t, u1, uphi)
        f, wi, pdf = _sample_ms_dielectric_aniso(
            alpha, rough, aniso, ior, wo, u2, lut_e_aniso, lut_eavg_aniso)
        return 2.0 * f * torch.abs(wi[..., 2]) * torch.abs(u1) / pdf

    return _mc(texel, (asize, size, size), spp, dev, samples_per_call=64)


def bake_E_avg_aniso(size=32, spp=32768, *, device="cuda"):
    """Cosine-weighted hemispherical average of bake_E_aniso:
    E̅_avg(rough, aniso), rows roughness, columns anisotropy (matching
    sample2d(lut, aniso, rough))."""
    dev = resolve_device(device)
    rough, aniso = _on(dev, *_grid((size, size)))
    alpha = ggx.alpha_from_roughness(rough, aniso)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, u1 = stream.next_1d()
        stream, uphi = stream.next_1d()
        sin_t = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
        wo = _azimuth_wo(sin_t, u1, uphi)
        f, wi, pdf = _sample_single_scatter(alpha, wo, u2)
        return 2.0 * f * torch.abs(wi[..., 2]) * u1 / pdf

    return _mc(texel, (size, size), spp, dev)


def bake_E_ms(lut_e, lut_eavg, size=32, spp=4096, *, device="cuda"):
    dev = resolve_device(device)
    iorp, rough, cos_t = _grid((size, size, size))
    ior, rough, cos_t = _on(dev, _ior(iorp, False), rough, cos_t)
    alpha = ggx.alpha_from_roughness(rough)
    wo = _wo_from_cos(cos_t)
    lut_e = torch.as_tensor(lut_e, device=dev)
    lut_eavg = torch.as_tensor(lut_eavg, device=dev)

    def texel(stream):
        _, u2 = stream.next_2d()
        f, wi, pdf = _sample_ms_dielectric(alpha, rough, ior, wo, u2, lut_e,
                                           lut_eavg)
        return f * torch.abs(wi[..., 2]) / pdf

    return _mc(texel, (size, size, size), spp, dev)


def bake_E_ms_avg(lut_e, lut_eavg, size=32, spp=16384, *, device="cuda"):
    dev = resolve_device(device)
    rough, iorp = _grid((size, size))
    rough, ior = _on(dev, rough, _ior(iorp, False))
    alpha = ggx.alpha_from_roughness(rough)
    lut_e = torch.as_tensor(lut_e, device=dev)
    lut_eavg = torch.as_tensor(lut_eavg, device=dev)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, u1 = stream.next_1d()
        wo = _wo_from_cos(u1)
        f, wi, pdf = _sample_ms_dielectric(alpha, rough, ior, wo, u2, lut_e,
                                           lut_eavg)
        return 2.0 * f * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2]) / pdf

    return _mc(texel, (size, size), spp, dev)


def bake_E_trans(out: bool, size=32, spp=4096, *, device="cuda"):
    dev = resolve_device(device)
    iorp, rough, cos_t = _grid((size, size, size))
    ior, rough, cos_t = _on(dev, _ior(iorp, out), rough, cos_t)
    alpha = ggx.alpha_from_roughness(rough)
    wo = _wo_from_cos(cos_t)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, u1 = stream.next_1d()
        u3 = torch.cat([u2, u1[..., None]], dim=-1)
        f, wi, pdf = _sample_transparent(alpha, ior, wo, u3)
        return f * torch.abs(wi[..., 2]) / pdf

    return _mc(texel, (size, size, size), spp, dev)


def bake_E_trans_avg(out: bool, size=32, spp=16384, *, device="cuda"):
    dev = resolve_device(device)
    rough, iorp = _grid((size, size))
    rough, ior = _on(dev, rough, _ior(iorp, out))
    alpha = ggx.alpha_from_roughness(rough)

    def texel(stream):
        stream, u2 = stream.next_2d()
        stream, ua = stream.next_1d()
        stream, ub = stream.next_1d()
        u3 = torch.cat([u2, ua[..., None]], dim=-1)
        wo = _wo_from_cos(ub)
        f, wi, pdf = _sample_transparent(alpha, ior, wo, u3)
        return 2.0 * f * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2]) / pdf

    return _mc(texel, (size, size), spp, dev)


def bake_all(spp_2d=4096, spp_avg=16384, spp_3d=2048, verbose=True,
             out_path=None, write_exr_slices=False, *, device="cuda"):
    """Bake every table (JAX lut_baker.py:389-446's order and spp rules),
    write the bundle to `out_path` (default the port's LUT_BUNDLE) and,
    with `write_exr_slices`, the EXR slices under RESOURCE_DIR/lut;
    returns {name: array}."""
    dev = resolve_device(device)

    def log(*a):
        if verbose:
            print(*a, flush=True)

    log("baking E (128x128)...")
    E = bake_E(spp=spp_2d, device=dev)
    log("baking E_avg (128)...")
    E_avg = bake_E_avg(spp=spp_avg, device=dev)
    log("baking E_ms (32^3)...")
    E_ms = bake_E_ms(E, E_avg, spp=spp_3d, device=dev)
    log("baking E_ms_avg (32^2)...")
    E_ms_avg = bake_E_ms_avg(E, E_avg, spp=spp_avg, device=dev)
    log("baking E_trans_in (32^3)...")
    E_trans_in = bake_E_trans(out=False, spp=spp_3d, device=dev)
    log("baking E_trans_out (32^3)...")
    E_trans_out = bake_E_trans(out=True, spp=spp_3d, device=dev)
    log("baking E_trans_in_avg / out_avg (32^2)...")
    E_trans_in_avg = bake_E_trans_avg(out=False, spp=spp_avg, device=dev)
    E_trans_out_avg = bake_E_trans_avg(out=True, spp=spp_avg, device=dev)
    log("baking E_aniso (32^3) / E_avg_aniso (32^2)...")
    E_aniso = bake_E_aniso(spp=max(spp_3d, 8192), device=dev)
    E_avg_aniso = bake_E_avg_aniso(spp=spp_avg * 2, device=dev)
    log("baking E_ms_aniso (8x32^3) / E_ms_avg_aniso (8x32^2)...")
    E_ms_aniso = bake_E_ms_aniso(E_aniso, E_avg_aniso, spp=spp_3d,
                                 device=dev)
    E_ms_avg_aniso = bake_E_ms_avg_aniso(E_aniso, E_avg_aniso, spp=spp_avg,
                                         device=dev)

    luts = dict(
        E=E, E_avg=E_avg, E_ms=E_ms, E_ms_avg=E_ms_avg,
        E_trans_in=E_trans_in, E_trans_out=E_trans_out,
        E_trans_in_avg=E_trans_in_avg, E_trans_out_avg=E_trans_out_avg,
        E_aniso=E_aniso, E_avg_aniso=E_avg_aniso,
        E_ms_aniso=E_ms_aniso, E_ms_avg_aniso=E_ms_avg_aniso,
    )
    out_path = out_path or LUT_BUNDLE
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **luts)
    log(f"wrote {out_path}")

    if write_exr_slices:
        from platinum_tpu_torch.io.exr import write_exr

        exr_dir = os.path.join(RESOURCE_DIR, "lut")
        os.makedirs(exr_dir, exist_ok=True)
        write_exr(os.path.join(exr_dir, "ggx_E.exr"), E)
        write_exr(os.path.join(exr_dir, "ggx_E_avg.exr"), E_avg[None, :])
        for name, arr in (("ggx_ms_E", E_ms), ("ggx_E_trans_in", E_trans_in),
                          ("ggx_E_trans_out", E_trans_out)):
            for z in range(arr.shape[0]):
                write_exr(os.path.join(exr_dir, f"{name}_{z}.exr"), arr[z])
        write_exr(os.path.join(exr_dir, "ggx_ms_E_avg.exr"), E_ms_avg)
        write_exr(os.path.join(exr_dir, "ggx_E_trans_in_avg.exr"),
                  E_trans_in_avg)
        write_exr(os.path.join(exr_dir, "ggx_E_trans_out_avg.exr"),
                  E_trans_out_avg)
    return luts


if __name__ == "__main__":
    bake_all()
