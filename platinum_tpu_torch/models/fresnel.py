"""Fresnel terms. Port of platinum_tpu/models/fresnel.py."""

from __future__ import annotations

import torch


def schlick(f0: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """Schlick approximation; f0 (..., 3) or (...,), cos_theta (...,)."""
    k = 1.0 - torch.clamp(cos_theta, 0.0, 1.0)
    k2 = k * k
    w = k2 * k2 * k
    if f0.dim() == cos_theta.dim() + 1:
        w = w[..., None]
    return f0 + (1.0 - f0) * w


def fresnel_dielectric(cos_theta: torch.Tensor, ior) -> torch.Tensor:
    """Exact unpolarized dielectric reflectance; ior = n_t / n_i (a tensor
    or a float). Total internal reflection -> 1."""
    cos_theta = torch.clamp(cos_theta, 0.0, 1.0)
    if torch.is_tensor(ior):
        ior = ior.to(dtype=cos_theta.dtype, device=cos_theta.device)
    else:
        # a fill, not a copy from the host
        ior = torch.full((), ior, dtype=cos_theta.dtype,
                         device=cos_theta.device)
    sin2_t = (1.0 - cos_theta * cos_theta) / torch.clamp(ior * ior, min=1e-20)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    parallel = (ior * cos_theta - cos_t) / torch.clamp(
        ior * cos_theta + cos_t, min=1e-20)
    perp = (cos_theta - ior * cos_t) / torch.clamp(
        cos_theta + ior * cos_t, min=1e-20)
    f = 0.5 * (parallel * parallel + perp * perp)
    return torch.where(sin2_t >= 1.0, 1.0, f)


def avg_dielectric_fresnel_fit(ior: torch.Tensor) -> torch.Tensor:
    """Kulla-Conty 2017 fit for the hemispherically-averaged Fresnel."""
    hi = (ior - 1.0) / (4.08567 + 1.00071 * ior)
    lo = 0.997118 + 0.1014 * ior - 0.965241 * ior * ior - 0.130607 * ior ** 3
    return torch.where(ior >= 1.0, hi, lo)


def avg_conductor_fresnel(albedo: torch.Tensor) -> torch.Tensor:
    """Average Schlick Fresnel for conductors: (20·F0 + 1)/21."""
    return (20.0 * albedo + 1.0) / 21.0
