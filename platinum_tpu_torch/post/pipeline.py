"""Post-processing pipeline, in torch, over one image.

Port of platinum_tpu/post/pipeline.py (parity with the reference's five
post passes + tonemap, renderer_pt.cpp:184-196 -> postprocess.metal:425-552):
exposure -> chromatic aberration -> contrast/saturation -> tone curve ->
vignette -> tonemap, in the reference's pass order. Chromatic aberration is
the only pass that is not per pixel (three bilinear taps, clamped).
`postprocess_jit` is the JAX package's jitted entry; here it is the same
plain function under the same name.
"""

from __future__ import annotations

import math

import torch

from platinum_tpu_torch.core import colorspace as cs
from platinum_tpu_torch.post import tonemap as tm
from platinum_tpu_torch.post.options import PostProcessOptions

LUMA = tm.LUMA


def _exposure(color, opt):
    return color * (2.0 ** opt.exposure)


def _contrast_saturation(color, opt):
    eps = 1e-6
    log_c = torch.log2(torch.clamp(color, min=0.0) + eps)
    k = 1.0 + opt.contrast * 0.01
    mid = math.log2(0.18)
    adj = mid + k * (log_c - mid)
    color = torch.clamp(torch.exp2(adj) - eps, min=0.0)

    gray = tm._luma(color)
    return gray + (1.0 + opt.saturation * 0.01) * (color - gray)


def _tone_curve(color, opt):
    def smoothstep(e0, e1, x):
        t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    luma = tm._luma(color)
    blacks = smoothstep(0.04, 0.0, luma)
    shadows = smoothstep(0.18, 0.0, luma)
    highlights = smoothstep(0.18, 1.0, luma)
    whites = smoothstep(0.75, 1.0, luma)
    ev = 0.01 * (opt.blacks * blacks + opt.shadows * shadows
                 + opt.highlights * highlights + opt.whites * whites)
    return color * torch.exp2(ev)


def _vignette(color, opt, uv, aspect):
    a = 1.0 + (aspect - 1.0) * opt.roundness * 0.01
    u = uv[..., 0]
    v = uv[..., 1]
    if aspect > 1.0:
        uvm = torch.stack([u, (v - 0.5) / a + 0.5], -1)
    else:
        uvm = torch.stack([(u - 0.5) * a + 0.5, v], -1)

    corner = math.sqrt(0.5)
    dist = torch.sqrt(torch.sum((uvm - 0.5) ** 2, dim=-1)) / corner
    end = 1.0 - opt.midpoint * 0.01
    start = end * (1.0 - opt.feather * 0.01)
    power = opt.power * 0.05
    d = torch.clamp((dist - start) / max(end - start, 1e-6), 0.0, 1.0)

    t = torch.clamp((dist - start) / max(end - start, 1e-6), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    vig = torch.where(d == 0.0, 0.0,
                      torch.pow(torch.clamp(d, min=1e-20), power)) * smooth
    return color * torch.exp2(opt.amount * vig)[..., None]


def _bilinear(img, uv):
    """Sample (H, W, 3) at normalised uv (..., 2), clamp addressing."""
    h, w = img.shape[:2]
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    c00 = img[y0i, x0i]
    c10 = img[y0i, x1i]
    c01 = img[y1i, x0i]
    c11 = img[y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _chromatic_aberration(img, opt, uv, aspect):
    if opt.amount == 0.0:
        return img

    def remap(uv, scale):
        # to aspect-compensated space, scale about the centre, back
        u, v = uv[..., 0], uv[..., 1]
        if aspect > 1.0:
            vm = (v - 0.5) / aspect + 0.5
            um = u
        else:
            um = (u - 0.5) * aspect + 0.5
            vm = v
        um = (um - 0.5) * scale + 0.5
        vm = (vm - 0.5) * scale + 0.5
        if aspect > 1.0:
            v2 = (vm - 0.5) * aspect + 0.5
            u2 = um
        else:
            u2 = (um - 0.5) / aspect + 0.5
            v2 = vm
        return torch.stack([u2, v2], -1)

    amount = opt.amount * 0.005 * 0.01
    r = _bilinear(img, remap(uv, 1.0 + amount))[..., 0]
    g = _bilinear(img, remap(uv, 1.0 - amount * opt.green_shift * 0.01))[..., 1]
    b = _bilinear(img, remap(uv, 1.0 - amount))[..., 2]
    return torch.stack([r, g, b], dim=-1)


def postprocess_image(image: torch.Tensor, options: PostProcessOptions,
                      working_space: str = "BT709",
                      output_space: str = "sRGB") -> torch.Tensor:
    """(H, W, 3) linear working-space radiance -> (H, W, 3) display-encoded,
    on the image's device. Pass order matches renderer_pt.cpp:184-196."""
    h, w = image.shape[:2]
    aspect = w / h
    dev = image.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    uv = torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1).float()

    color = _exposure(image, options.exposure)
    color = _chromatic_aberration(color, options.chromatic_aberration, uv,
                                  aspect)
    color = _contrast_saturation(color, options.contrast_saturation)
    color = _tone_curve(color, options.tone_curve)
    color = _vignette(color, options.vignette, uv, aspect)

    odt = cs.transform(cs.get_colorspace(working_space),
                       cs.get_colorspace(output_space))
    return torch.clamp(tm.apply_tonemap(color, options.tonemap, odt),
                       0.0, 1.0)


postprocess_jit = postprocess_image
