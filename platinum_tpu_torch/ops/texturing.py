"""Texture sampling from the packed atlas, in torch.

Port of platinum_tpu/ops/texturing.py: textures are shelf-packed into one
RGBA atlas at flatten time (render/flatten._pack_atlas) and sampled here
with explicit bilinear gathers, repeat-wrapped within each atlas
sub-rectangle, as the JAX package does (a GPU's texture units would filter
in their own fixed-point arithmetic, so the gathers stay explicit). u8
texels decode (sRGB or linear) after each tap and before the blend.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from platinum_tpu_torch.core.material import TextureSlot


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def mul3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v @ m.T for (..., 3) colours and a (3, 3) matrix, as three fp32
    multiply-adds per channel: no tensor-core (TF32) product."""
    m = m.to(v.dtype)
    return (v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1]
            + v[..., 2:3] * m[:, 2])


def sample_atlas(atlas: torch.Tensor, entry: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, repeat-wrapped sample.

    atlas: (AH, AW, 4) f32 (linear) or u8 (storage encoding); entry:
    (R, 5) int32 (x, y, w, h, srgb_flag); uv: (R, 2). Returns (R, 4)
    linear. Entries with w == 0 return zeros. The texel wrap is
    torch.remainder (the sign of the divisor, as jnp.mod), not fmod."""
    x0e = entry[..., 0].to(torch.float32)
    y0e = entry[..., 1].to(torch.float32)
    w = torch.clamp(entry[..., 2].to(torch.float32), min=1.0)
    h = torch.clamp(entry[..., 3].to(torch.float32), min=1.0)
    is_u8 = atlas.dtype == torch.uint8
    srgb = ((entry[..., 4] == 1)[..., None] if entry.shape[-1] > 4
            else torch.zeros_like(entry[..., :1], dtype=torch.bool))

    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    uf = torch.floor(u)
    vf = torch.floor(v)
    fu = (u - uf)[..., None]
    fv = (v - vf)[..., None]

    def texel(ui, vi):
        ui = torch.remainder(ui, w)
        vi = torch.remainder(vi, h)
        xi = (x0e + ui).to(torch.int32).long()
        yi = (y0e + vi).to(torch.int32).long()
        t = atlas[yi, xi]
        if not is_u8:
            return t
        f = t.to(torch.float32) * (1.0 / 255.0)
        rgb = torch.where(srgb, _srgb_to_linear(f[..., :3]), f[..., :3])
        return torch.cat([rgb, f[..., 3:4]], dim=-1)

    c00 = texel(uf, vf)
    c10 = texel(uf + 1, vf)
    c01 = texel(uf, vf + 1)
    c11 = texel(uf + 1, vf + 1)
    out = ((c00 * (1 - fu) + c10 * fu) * (1 - fv)
           + (c01 * (1 - fu) + c11 * fu) * fv)
    return torch.where((entry[..., 2] > 0)[..., None], out, 0.0)


@dataclass(frozen=True)
class TexSamples:
    has_base: torch.Tensor
    base_rgb: torch.Tensor
    base_alpha: torch.Tensor
    has_emission: torch.Tensor
    emission_rgb: torch.Tensor
    has_rm: torch.Tensor
    rough: torch.Tensor
    metal: torch.Tensor
    has_transmission: torch.Tensor
    transmission: torch.Tensor
    has_clearcoat: torch.Tensor
    clearcoat: torch.Tensor


def _entry(atlas_table, tex_ids, slot):
    tid = tex_ids[..., int(slot)]
    has = tid >= 0
    entry = atlas_table[torch.clamp(tid, min=0).long()]
    entry = torch.where(has[..., None], entry, 0)
    return has, entry


def sample_material_textures(atlas, atlas_table, tex_ids, uv,
                             idt=None, slots=None) -> TexSamples:
    """Gather all non-normal material texture slots for a batch of rays.
    tex_ids: (R, 6) i32 atlas entries (-1 = unbound). `slots` (a frozenset
    of TextureSlot ints, from flatten.analyze_features) prunes slots no
    material in the scene binds. `idt` (3, 3), when given, maps the base
    and emission colours (three fp32 multiply-adds, no TF32)."""
    n = uv.shape[0]
    dev = uv.device

    def slot_sample(slot):
        if slots is not None and int(slot) not in slots:
            return (torch.zeros((n,), dtype=torch.bool, device=dev),
                    torch.zeros((n, 4), device=dev))
        has, e = _entry(atlas_table, tex_ids, slot)
        return has, sample_atlas(atlas, e, uv)

    has_base, base = slot_sample(TextureSlot.BASE_COLOR)
    has_em, emission = slot_sample(TextureSlot.EMISSION)
    has_rm, rm = slot_sample(TextureSlot.ROUGHNESS_METALLIC)
    has_tr, tr = slot_sample(TextureSlot.TRANSMISSION)
    has_cc, cc = slot_sample(TextureSlot.CLEARCOAT)

    base_rgb = base[..., :3]
    em_rgb = emission[..., :3]
    if idt is not None:
        base_rgb = mul3(base_rgb, idt)
        em_rgb = mul3(em_rgb, idt)

    return TexSamples(
        has_base=has_base,
        base_rgb=base_rgb,
        base_alpha=base[..., 3],
        has_emission=has_em,
        emission_rgb=em_rgb,
        has_rm=has_rm,
        rough=rm[..., 0],
        metal=rm[..., 1],
        has_transmission=has_tr,
        transmission=tr[..., 0],
        has_clearcoat=has_cc,
        clearcoat=cc[..., 0],
    )


def sample_normal_map(atlas, atlas_table, tex_ids, uv):
    """(has (R,), tangent-space normal (R, 3)) for the normal slot, the
    values mapped from [0, 1] to [-1, 1]."""
    has, e = _entry(atlas_table, tex_ids, TextureSlot.NORMAL)
    n = sample_atlas(atlas, e, uv)[..., :3] * 2.0 - 1.0
    return has, n


def sample_base_alpha(atlas, atlas_table, tex_ids, uv):
    """Base-colour alpha only (for stochastic-transparency any-hit tests);
    1 where the slot is unbound."""
    has, e = _entry(atlas_table, tex_ids, TextureSlot.BASE_COLOR)
    a = sample_atlas(atlas, e, uv)[..., 3]
    return torch.where(has, a, 1.0)
