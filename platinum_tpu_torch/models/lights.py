"""Light sampling: power-proportional area lights and alias-sampled env maps.

Port of platinum_tpu/models/lights.py: alias-table area-light picks with a
uniform point on the triangle (solid-angle pdf), the equirect environment
with its alias table and true solid-angle density, and pInfinite. Unlike
the JAX package, an emitter with an emission texture emits the factor
times the texel in NEE too (glTF's emitted radiance), not the factor
alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops import samplers as smp
from platinum_tpu_torch.ops.frame import cross, dot, normalize
from platinum_tpu_torch.ops.texturing import sample_atlas
from platinum_tpu_torch.render.types import (LIGHT_ROW_TEXTURED,
                                             EnvironmentLight, Geometry,
                                             LightTable)

ENV_DISTANCE = 1e7


@dataclass(frozen=True)
class LightSample:
    li: torch.Tensor        # (R, 3) emitted radiance
    wi: torch.Tensor        # (R, 3) world direction surface -> light
    dist: torch.Tensor      # (R,)
    pdf: torch.Tensor       # (R,) pdf of the position/direction sample
    p_light: torch.Tensor   # (R,) probability of picking this light


def dir_to_equirect_uv(d):
    phi = torch.atan2(-d[..., 2], -d[..., 0])
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return torch.stack([phi / (2.0 * np.pi), theta / np.pi], dim=-1)


def equirect_uv_to_dir(uv):
    y = torch.cos(uv[..., 1] * np.pi)
    r = torch.sin(uv[..., 1] * np.pi)
    phi = uv[..., 0] * 2.0 * np.pi
    d = torch.stack([-torch.cos(phi) * r, y, -torch.sin(phi) * r], dim=-1)
    return normalize(d)


def env_radiance(env: EnvironmentLight, d):
    """Bilinear env lookup for a world direction (wrap-x, clamp-y)."""
    h, w = env.pixels.shape[:2]
    uv = dir_to_equirect_uv(d)
    x = uv[..., 0] * w - 0.5
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = env.pixels[y0i, x0i]
    c10 = env.pixels[y0i, x1i]
    c01 = env.pixels[y1i, x0i]
    c11 = env.pixels[y1i, x1i]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def _equirect_density(pdf_pixel, sin_theta):
    return pdf_pixel / (2.0 * np.pi * np.pi * torch.clamp(sin_theta, min=1e-4))


def env_pdf_of_dir(env: EnvironmentLight, d):
    """Solid-angle pdf the env sampler assigns to direction d."""
    h, w = env.pixels.shape[:2]
    uv = dir_to_equirect_uv(d)
    x = torch.clamp(torch.remainder(uv[..., 0], 1.0) * w, 0, w - 1).long()
    y = torch.clamp(uv[..., 1] * h, 0, h - 1).long()
    sin_theta = torch.sqrt(torch.clamp(1.0 - d[..., 1] * d[..., 1], min=0.0))
    return _equirect_density(env.pdf[y * w + x], sin_theta)


def sample_env_light(env: EnvironmentLight, u2) -> LightSample:
    """Alias-table draw with a jittered position inside the texel."""
    h, w = env.pixels.shape[:2]
    n = h * w
    scaled = u2[..., 0] * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    ux = torch.clamp(scaled - slot.to(torch.float32), 0.0, 1.0)

    p_slot = env.p[slot]
    take_alias = u2[..., 1] >= p_slot
    i = torch.where(take_alias, env.alias[slot].long(), slot)
    uy = torch.where(take_alias,
                     (u2[..., 1] - p_slot) / torch.clamp(1.0 - p_slot, min=1e-9),
                     u2[..., 1] / torch.clamp(p_slot, min=1e-9))
    uy = torch.clamp(uy, 0.0, 1.0 - 1e-6)

    x = i % w
    y = i // w
    uv = torch.stack([(x.to(torch.float32) + ux) / w,
                      (y.to(torch.float32) + uy) / h], -1)
    wi = equirect_uv_to_dir(uv)
    li = env_radiance(env, wi)
    sin_theta = torch.sin(uv[..., 1] * np.pi)
    pdf = _equirect_density(env.pdf[i], sin_theta)
    return LightSample(li=li, wi=wi,
                       dist=torch.full(i.shape, ENV_DISTANCE, device=u2.device),
                       pdf=pdf, p_light=torch.ones(i.shape, device=u2.device))


def sample_area_light(geometry: Geometry, lights: LightTable, hit_pos,
                      u_select, u2, atlas=None,
                      atlas_table=None) -> LightSample:
    """Power-proportional alias pick + uniform point on the triangle.

    Where the rows carry uvs and an emission-texture entry (types.
    LIGHT_ROW_TEXTURED, and an atlas is given) the emitted radiance is
    the factor times the texel at the sampled point, as glTF defines it:
    the point's uv is interpolated with the barycentrics that place it,
    and the texel is a bilinear atlas tap (ops/texturing.sample_atlas).
    The pick stays the factor's power. Rows without a texture (entry -1)
    give the factor alone."""
    n = lights.packed.shape[0]
    scaled = u_select * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    frac = torch.clamp(scaled - slot.to(torch.float32), 0.0, 1.0)
    row = lookup.rows(lights.packed, slot)
    take_alias = frac >= row[..., 14]
    alias = row[..., 15].long()   # value float, see flatten
    idx = torch.where(take_alias, alias, slot)
    row = lookup.rows(lights.packed, idx)

    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    emission = row[..., 9:12]
    area = row[..., 12]
    p_light = row[..., 13]

    b = smp.sample_tri_uniform(u2)
    pos = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    nrm = normalize(cross(e1, e2))

    delta = pos - hit_pos
    dist2 = torch.sum(delta * delta, dim=-1)
    dist = torch.sqrt(dist2)
    wi = delta / torch.clamp(dist[..., None], min=1e-20)
    cos_l = torch.abs(dot(nrm, wi))
    pdf = dist2 / torch.clamp(cos_l * area, min=1e-20)
    if atlas is not None and row.shape[-1] == LIGHT_ROW_TEXTURED:
        emission = emission * _emission_texel(row, b, atlas, atlas_table)
    return LightSample(li=emission, wi=wi, dist=dist, pdf=pdf, p_light=p_light)


def _emission_texel(row, b, atlas, atlas_table):
    """(R, 3) linear emission texel of light rows at barycentrics b; 1
    where a row binds no texture."""
    w = 1.0 - b[..., 0:1] - b[..., 1:2]
    uv = row[..., 16:18] * w + row[..., 18:20] * b[..., 0:1] \
        + row[..., 20:22] * b[..., 1:2]
    tid = row[..., 22].long()   # value float, see flatten
    has = tid >= 0
    entry = torch.where(has[..., None],
                        atlas_table[torch.clamp(tid, min=0)], 0)
    texel = sample_atlas(atlas, entry, uv)[..., :3]
    return torch.where(has[..., None], texel, 1.0)


def p_infinite(lights: LightTable, env: EnvironmentLight) -> torch.Tensor:
    """Probability of sampling the env light; 0 when there is none."""
    n_env = env.count.to(torch.float32)
    base = torch.where(lights.count == 0, 1.0, n_env / (n_env + 1.0))
    return torch.where(env.count == 0,
                       torch.where(lights.count == 0, 1.0, 0.0), base)
