"""Trowbridge-Reitz GGX microfacet distribution.

Port of platinum_tpu/models/ggx.py: anisotropic NDF, Smith height-
correlated masking/shadowing, spherical-cap VNDF sampling, reflection pdf
and the smooth-surface cutoff. Directions are tangent-space (+Z normal);
`alpha` is (..., 2).
"""

from __future__ import annotations

import numpy as np
import torch

from platinum_tpu_torch.ops.frame import (const_like, cross, dot, norm,
                                          normalize)
from platinum_tpu_torch.ops.samplers import sample_disk

SMOOTH_ALPHA = 1e-3


def alpha_from_roughness(roughness, anisotropy=None):
    """(..., 2) GGX alphas; anisotropy stretches x/y (aspect =
    sqrt(1 - 0.9·aniso))."""
    a = roughness * roughness
    if anisotropy is None:
        return torch.stack([a, a], dim=-1)
    aspect = torch.sqrt(1.0 - 0.9 * anisotropy)
    return torch.stack([a / aspect, a * aspect], dim=-1)


def is_smooth(alpha):
    return (alpha[..., 0] < SMOOTH_ALPHA) & (alpha[..., 1] < SMOOTH_ALPHA)


def mdf(alpha, w):
    """Microfacet (normal) distribution function D(w)."""
    ax, ay = alpha[..., 0], alpha[..., 1]
    cos2 = w[..., 2] * w[..., 2]
    cos4 = cos2 * cos2
    k = (w[..., 0] * w[..., 0] / (ax * ax) + w[..., 1] * w[..., 1] / (ay * ay)
         ) / torch.clamp(cos2, min=1e-20)
    k = (1.0 + k) * (1.0 + k)
    return 1.0 / (np.pi * ax * ay * torch.clamp(cos4 * k, min=1e-20))


def _lambda(alpha, w):
    ax, ay = alpha[..., 0], alpha[..., 1]
    cos2 = torch.clamp(w[..., 2] * w[..., 2], min=1e-20)
    alpha2 = torch.where(
        ax == ay, ax * ax,
        ax * ax * w[..., 0] * w[..., 0] + ay * ay * w[..., 1] * w[..., 1])
    return (torch.sqrt(1.0 + alpha2 / cos2) - 1.0) * 0.5


def g1(alpha, w):
    return 1.0 / (1.0 + _lambda(alpha, w))


def g(alpha, wo, wi):
    return 1.0 / (1.0 + _lambda(alpha, wo) + _lambda(alpha, wi))


def vmdf(alpha, w, wm):
    """Visible NDF."""
    return (g1(alpha, w) / torch.clamp(torch.abs(w[..., 2]), min=1e-20)
            * mdf(alpha, wm) * torch.abs(dot(w, wm)))


def sample_vmdf(alpha, w, u):
    """Sample a visible microfacet normal (spherical-cap method)."""
    wh = torch.stack([w[..., 0] * alpha[..., 0], w[..., 1] * alpha[..., 1],
                      w[..., 2]], dim=-1)
    wh = normalize(wh)
    wh = wh * torch.where(wh[..., 2:3] < 0.0, -1.0, 1.0)

    b_raw = cross(const_like((0.0, 0.0, 1.0), wh), wh)
    b_len = norm(b_raw, keepdim=True)
    b = torch.where(wh[..., 2:3] < 0.9999,
                    b_raw / torch.clamp(b_len, min=1e-20),
                    const_like((1.0, 0.0, 0.0), wh))
    t = cross(wh, b)

    p = sample_disk(u)
    h = torch.sqrt(torch.clamp(1.0 - p[..., 0] * p[..., 0], min=0.0))
    mix_t = 0.5 * wh[..., 2] + 0.5
    py = h * (1.0 - mix_t) + p[..., 1] * mix_t
    pz = torch.sqrt(torch.clamp(1.0 - p[..., 0] ** 2 - py ** 2, min=0.0))
    nh = b * p[..., 0:1] + t * py[..., None] + wh * pz[..., None]

    wm = torch.stack([alpha[..., 0] * nh[..., 0], alpha[..., 1] * nh[..., 1],
                      torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    return normalize(wm)


def single_scatter_brdf(alpha, wo, wi, wm):
    return (mdf(alpha, wm) * g(alpha, wo, wi)
            / torch.clamp(4.0 * torch.abs(wo[..., 2]) * torch.abs(wi[..., 2]),
                          min=1e-20))


def pdf(alpha, wo, wm):
    """pdf of sample_vmdf-generated reflections."""
    return vmdf(alpha, wo, wm) / torch.clamp(
        4.0 * torch.abs(dot(wo, wm)), min=1e-20)


def reflect(i, n):
    """Metal-convention reflect: i points toward the surface."""
    return i - 2.0 * torch.sum(i * n, dim=-1, keepdim=True) * n


def refract(i, n, eta):
    """Metal-convention refract; 0-vector on total internal reflection.
    eta = n_incident / n_transmitted."""
    if not torch.is_tensor(eta):
        # a fill, not a copy from the host
        eta = torch.full((), eta, dtype=i.dtype, device=i.device)
    eta = torch.broadcast_to(eta.to(dtype=i.dtype, device=i.device),
                             i.shape[:-1])[..., None]
    cos_i = torch.sum(n * i, dim=-1, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * i - (eta * cos_i + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, 0.0, out)
