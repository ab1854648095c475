"""Tonemapping operators, in torch, vectorised over (H, W, 3) images.

Port of platinum_tpu/post/tonemap.py (parity with the tonemap stage of
postprocess.metal:91-412 + 554-600): AgX (inset matrix, log2 range map,
6th-order contrast polynomial, look, outset), Khronos PBR Neutral, and the
flim film-emulation chain (gamut extension, super-sigmoid dye development,
negative + print, black point, midtone saturation), followed by
lift/gamma/gain grading, the working -> display ODT matrix and the sRGB
EOTF. The option math on the host (`_hsv_to_rgb_np`, `_flim_gamut_matrix`)
stays numpy. Every colour matrix is applied as fp32 multiply-adds
(ops/texturing.mul3): no TF32 product on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from platinum_tpu_torch.ops.frame import rdiv
from platinum_tpu_torch.ops.texturing import mul3
from platinum_tpu_torch.post.options import (FlimOptions, KhronosPbrOptions,
                                             LiftGammaGain, TonemapOptions)

LUMA = (0.2126, 0.7152, 0.0722)

# AgX inset/outset matrices (columns as in the MSL float3x3 literals)
_AGX_IN = np.column_stack([
    (0.842479062253094, 0.0423282422610123, 0.0423756549057051),
    (0.0784335999999992, 0.878468636469772, 0.0784336),
    (0.0792237451477643, 0.0791661274605434, 0.879142973793104),
]).astype(np.float32)
_AGX_OUT = np.column_stack([
    (1.19687900512017, -0.0528968517574562, -0.0529716355144438),
    (-0.0980208811401368, 1.15190312990417, -0.0980434501171241),
    (-0.0990297440797205, -0.0989611768448433, 1.15107367264116),
]).astype(np.float32)
_AGX_MIN_EV = -12.47393
_AGX_MAX_EV = 4.026069


def _t(x, like):
    """A host constant as an f32 tensor on `like`'s device."""
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def _sat(x):
    return torch.clamp(x, 0.0, 1.0)


def _mul(m, v):
    """Apply a (3, 3) matrix to (..., 3) colours (column vectors)."""
    return mul3(v, _t(m, v))


def _luma(v):
    return torch.sum(v * _t(LUMA, v), dim=-1, keepdim=True)


def _agx_contrast(x):
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4
            - 6.868 * x2 * x + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(val: torch.Tensor, look) -> torch.Tensor:
    val = _mul(_AGX_IN, val)
    val = torch.clamp(torch.log2(torch.clamp(val, min=1e-10)),
                      _AGX_MIN_EV, _AGX_MAX_EV)
    val = (val - _AGX_MIN_EV) / (_AGX_MAX_EV - _AGX_MIN_EV)
    val = _agx_contrast(val)

    # look
    luma = _luma(val)
    val = torch.pow(torch.clamp(val * _t(look.slope, val)
                                + _t(look.offset, val), min=0.0),
                    _t(look.power, val))
    val = luma + look.saturation * (val - luma)

    return _sat(_mul(_AGX_OUT, val))


def khronos_pbr(val: torch.Tensor, opt: KhronosPbrOptions) -> torch.Tensor:
    compression_start = opt.compression_start - 0.04
    x = torch.amin(val, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    val = val - offset

    peak = torch.amax(val, dim=-1, keepdim=True)
    d = 1.0 - compression_start
    new_peak = 1.0 - rdiv(d * d, torch.clamp(peak + d - compression_start,
                                             min=1e-6))
    compressed = val * new_peak / torch.clamp(peak, min=1e-6)
    g = 1.0 - 1.0 / (opt.desaturation
                     * torch.clamp(peak - new_peak, min=0.0) + 1.0)
    out = compressed + g * (new_peak - compressed)
    return torch.where(peak < compression_start, val, out)


# ---------------------------------------------------------------------------
# flim
# ---------------------------------------------------------------------------

def _rgb_avg(c):
    return torch.mean(c, dim=-1, keepdim=True)


def _hsv_from_rgb(rgb):
    cmax = torch.amax(rgb, dim=-1)
    cmin = torch.amin(rgb, dim=-1)
    delta = cmax - cmin
    safe = torch.clamp(delta, min=1e-20)
    c = (cmax[..., None] - rgb) / safe[..., None]
    r_is = rgb[..., 0] == cmax
    g_is = (rgb[..., 1] == cmax) & ~r_is
    h = torch.where(
        r_is, c[..., 2] - c[..., 1],
        torch.where(g_is, 2.0 + c[..., 0] - c[..., 2],
                    4.0 + c[..., 1] - c[..., 0])) / 6.0
    h = torch.where(h < 0, h + 1.0, h)
    s = torch.where(cmax != 0.0, delta / torch.clamp(cmax, min=1e-20), 0.0)
    h = torch.where(s == 0.0, 0.0, h)
    return torch.stack([h, s, cmax], dim=-1)


def _rgb_from_hsv(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = torch.where(h == 1.0, 0.0, h) * 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(cases, default):      # jnp.select: the first true case
        out = default
        for k in range(len(cases) - 1, -1, -1):
            out = torch.where(i == k, cases[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    out = torch.stack([r, g, b], dim=-1)
    return torch.where((s == 0.0)[..., None], v[..., None], out)


def _hue_sat(color, hue, sat, value):
    hsv = _hsv_from_rgb(color)
    h = torch.remainder(hsv[..., 0] + hue + 0.5, 1.0)
    s = _sat(hsv[..., 1] * sat)
    v = hsv[..., 2] * value
    return _rgb_from_hsv(torch.stack([h, s, v], dim=-1))


def _hsv_to_rgb_np(h, s, v):
    """Host-side HSV->RGB (Blender convention), for static option math."""
    if s == 0.0:
        return np.array([v, v, v])
    if h == 1.0:
        h = 0.0
    h *= 6.0
    i = int(np.floor(h))
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    return np.array([
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
    ][i % 6])


def _flim_gamut_matrix(opt: FlimOptions) -> np.ndarray:
    def col(primary_hue, scale, rotate, mul):
        h = (primary_hue + rotate / 360.0) % 1.0
        rgb = _hsv_to_rgb_np(h, 1.0 / scale, 1.0)
        rgb = rgb / rgb.sum()
        return rgb * mul

    cols = [
        col(0.0, opt.extended_gamut_scale[0], opt.extended_gamut_rotation[0],
            opt.extended_gamut_mul[0]),
        col(1 / 3, opt.extended_gamut_scale[1], opt.extended_gamut_rotation[1],
            opt.extended_gamut_mul[1]),
        col(2 / 3, opt.extended_gamut_scale[2], opt.extended_gamut_rotation[2],
            opt.extended_gamut_mul[2]),
    ]
    return np.column_stack(cols).astype(np.float32)


def _super_sigmoid(x, toe, shoulder):
    x = _sat(x)
    tx, ty = float(np.clip(toe[0], 0, 1)), float(np.clip(toe[1], 0, 1))
    sx = float(np.clip(shoulder[0], 0, 1))
    sy = float(np.clip(shoulder[1], 0, 1))
    slope = (sy - ty) / (sx - tx)

    toe_val = ty * torch.pow(torch.clamp(x / tx, min=1e-20),
                             slope * tx / ty)
    lin_val = slope * x + ty - slope * tx
    sh_pow = -slope / ((sx - 1.0) / (1.0 - sx) ** 2 * (1.0 - sy))
    sh_val = (1.0 - torch.pow(torch.clamp(1.0 - (x - sx) / (1.0 - sx),
                                          min=0.0), sh_pow)) \
        * (1.0 - sy) + sy
    return torch.where(x < tx, toe_val, torch.where(x < sx, lin_val, sh_val))


def _dye_mix_factor(mono, max_density, opt: FlimOptions):
    offset = 2.0 ** opt.sigmoid_log2_min
    fac = _sat(
        (torch.log2(mono + offset) - opt.sigmoid_log2_min)
        / (opt.sigmoid_log2_max - opt.sigmoid_log2_min))
    fac = _super_sigmoid(fac, opt.sigmoid_toe, opt.sigmoid_shoulder)
    return _sat(torch.exp2(-fac * max_density))


def _rgb_color_layer(color, sensitivity, dye, max_density, opt):
    sensitivity = np.asarray(sensitivity, np.float32)
    sensitivity = sensitivity / sensitivity.sum()
    dye = np.asarray(dye, np.float32)
    dye = _t(dye / dye.max(), color)
    mono = torch.sum(color * _t(sensitivity, color), dim=-1, keepdim=True)
    mix = _dye_mix_factor(mono, max_density, opt)
    return dye + mix * (1.0 - dye)


def _rgb_develop(color, exposure, max_density, opt):
    color = color * (2.0 ** exposure)
    out = _rgb_color_layer(color, (0, 0, 1), (1, 1, 0), max_density, opt)
    out = out * _rgb_color_layer(color, (0, 1, 0), (1, 0, 1), max_density,
                                 opt)
    out = out * _rgb_color_layer(color, (1, 0, 0), (0, 1, 1), max_density,
                                 opt)
    return out


def _negative_and_print(color, backlight, opt):
    color = _rgb_develop(color, opt.negative_exposure, opt.negative_density,
                         opt)
    color = color * backlight
    return _rgb_develop(color, opt.print_exposure, opt.print_density, opt)


def _rgb_uniform_offset(color, black_point, white_point):
    mono = _rgb_avg(color)
    lo = black_point / 1000.0
    hi = 1.0 - white_point / 1000.0
    mono2 = _sat((mono - lo) / (hi - lo))
    return color * mono2 / torch.clamp(mono, min=1e-20)


def flim(val: torch.Tensor, opt: FlimOptions) -> torch.Tensor:
    val = val * (2.0 ** opt.pre_exposure)

    ext = _flim_gamut_matrix(opt)
    ext_inv = np.linalg.inv(ext).astype(np.float32)
    backlight = _t(np.asarray(opt.print_backlight, np.float32) @ ext, val)

    big = torch.full((1, 3), 1e7, device=val.device)
    white_cap = _negative_and_print(big, backlight, opt)

    pf = _t(opt.pre_formation_filter, val)
    val = val + opt.pre_formation_filter_strength * (val * pf - val)

    val = mul3(val, _t(ext.T, val))               # val @ ext
    val = _negative_and_print(val, backlight, opt)
    val = mul3(val, _t(ext_inv.T, val))           # val @ ext_inv

    val = torch.clamp(val, min=0.0) / white_cap

    if opt.auto_black_point:
        black_cap = _negative_and_print(
            torch.zeros((1, 3), device=val.device), backlight, opt) / white_cap
        val = _rgb_uniform_offset(val, torch.mean(black_cap) * 1000.0, 0.0)
    else:
        val = _rgb_uniform_offset(val, opt.black_point, 0.0)

    pof = _t(opt.post_formation_filter, val)
    val = val + opt.post_formation_filter_strength * (val * pof - val)

    val = _sat(val)
    mono = _rgb_avg(val)[..., 0]
    mix = torch.where(mono < 0.5, _sat((mono - 0.05) / 0.45),
                      _sat((mono - 0.95) / -0.45))
    sat_val = _hue_sat(val, 0.5, opt.midtone_saturation, 1.0)
    val = val + mix[..., None] * (sat_val - val)
    return _sat(val)


# ---------------------------------------------------------------------------
# Grading + ODT + EOTF
# ---------------------------------------------------------------------------

def lift_gamma_gain(color: torch.Tensor, lgg: LiftGammaGain) -> torch.Tensor:
    lift_c = np.asarray(lgg.shadow_color, np.float32)
    lift_c = lift_c - lift_c.mean()
    gamma_c = np.asarray(lgg.midtone_color, np.float32)
    gamma_c = gamma_c - gamma_c.mean()
    gain_c = np.asarray(lgg.highlight_color, np.float32)
    gain_c = gain_c - gain_c.mean()

    lift = lift_c + lgg.shadow_offset * 0.01
    gain = 1.0 + gain_c + lgg.highlight_offset * 0.01
    mid_gray = 0.5 + gamma_c + lgg.midtone_offset * 0.01
    gamma = np.log10(np.maximum((0.5 - lift)
                                / np.maximum(gain - lift, 1e-6), 1e-6)) \
        / np.log10(np.maximum(mid_gray, 1e-6))

    t = _sat(torch.pow(torch.clamp(color, min=0.0), 1.0 / _t(gamma, color)))
    return _t(lift, color) + t * (_t(gain, color) - _t(lift, color))


def srgb_eotf_encode(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c < 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def apply_tonemap(color: torch.Tensor, opt: TonemapOptions,
                  odt) -> torch.Tensor:
    """Full tonemap stage: operator -> LGG grading -> ODT -> sRGB encode.
    `odt` is the (3, 3) working -> display matrix."""
    name = opt.tonemapper.lower()
    if name == "agx":
        color = agx(color, opt.agx_look)
        color = torch.pow(torch.clamp(color, min=0.0), 2.2)  # linearise
    elif name in ("khronos_pbr", "khronos", "pbr_neutral"):
        color = khronos_pbr(color, opt.khronos)
    elif name == "flim":
        color = flim(color, opt.flim)
    color = lift_gamma_gain(color, opt.lift_gamma_gain)
    color = _mul(odt, color)
    return srgb_eotf_encode(color)
