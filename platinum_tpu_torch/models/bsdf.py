"""Principled BSDF, vectorised over rays.

Port of platinum_tpu/models/bsdf.py, every lobe: metallic conductor (GGX +
Schlick + Kulla-Conty multiscatter), transparent dielectric (rough and
smooth, thick and thin, Turquin compensation), opaque dielectric (GGX +
energy-compensated diffuse) and clearcoat, with anisotropy rotation and
the per-material energy rows or the LUTs. The estimator and its documented
deviations from the Metal reference are the JAX package's (see its module
docstring). `make_shading_context` samples the material textures of
ops/texturing.py when the scene has an atlas.

`sample` and `evaluate` launch the hand-written CUDA kernel of
csrc/bsdf_shade.cu on CUDA tensors (one pass a lane over every lobe and
switch, the scene's features as a bit mask: `feature_mask`) and raise on
what it does not take; on CPU tensors they run `sample_plain` and
`evaluate_plain`, the plain PyTorch code the kernel is held to.
`LAUNCHES` counts the launches; counter `bsdf.kernel_lanes` the lanes
they shaded and `bsdf.lanes` the lanes both functions were given.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from platinum_tpu_torch.models import fresnel, ggx
from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops import luts as luts_mod
from platinum_tpu_torch.ops import samplers as smp
from platinum_tpu_torch.ops.frame import const_like, dot, norm
from platinum_tpu_torch.ops.texturing import sample_material_textures
from platinum_tpu_torch.render.types import (
    MAT_ANISOTROPIC,
    MAT_EMISSIVE,
    MAT_THIN,
    MaterialTable,
)
from platinum_tpu_torch.utils import telemetry

# Sample flag bits (parity with bsdf::SampleFlags)
SAMPLE_REFLECTED = 1
SAMPLE_TRANSMITTED = 2
SAMPLE_DIFFUSE = 4
SAMPLE_GLOSSY = 8
SAMPLE_SPECULAR = 16
SAMPLE_EMITTED = 32

MIN_COS = 1.5e-3
CLEARCOAT_IOR = 1.5


@dataclass(frozen=True)
class ShadingContext:
    """Per-ray shading parameters; all fields (R,) or (R, k)."""

    albedo: torch.Tensor
    emission: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    anisotropy: torch.Tensor
    anisotropy_rotation: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    flags: torch.Tensor                       # (R,) i32
    energy: torch.Tensor | None = None        # (M, K, 6)
    energy_avg: torch.Tensor | None = None    # (M, 4)
    mat_idx: torch.Tensor | None = None       # (R,)
    tex_rows: torch.Tensor | None = None      # (R, 6) atlas entries
    energy_avg_row: torch.Tensor | None = None  # (R, 4)

    @property
    def alpha(self):
        aniso = torch.where((self.flags & MAT_ANISOTROPIC) != 0,
                            self.anisotropy, 0.0)
        return ggx.alpha_from_roughness(self.roughness, aniso)

    @property
    def coat_alpha(self):
        return ggx.alpha_from_roughness(self.clearcoat_roughness)

    @property
    def thin(self):
        return (self.flags & MAT_THIN) != 0


def make_shading_context(materials: MaterialTable, mat_idx: torch.Tensor,
                         rows, uv: torch.Tensor | None = None, atlas=None,
                         atlas_table=None, slots=None) -> ShadingContext:
    """Material parameters per ray from the packed material rows, with the
    texture lookups applied when an atlas is present: a base-colour
    texture replaces the base colour, emission, roughness and metallic
    textures multiply their factors, transmission and clearcoat textures
    replace theirs (JAX bsdf.py:132-143). `rows` are the rows of
    `mat_idx` (ops/hitdata.py `HitRows`, as `fetch_hit` reads them; the
    atlas entries where there is an atlas)."""
    row = rows.mat
    albedo = row[..., 0:3]
    emission = row[..., 4:7]
    roughness = row[..., 7]
    metallic = row[..., 8]
    transmission = row[..., 9]
    clearcoat = row[..., 13]
    tex_rows = None
    if atlas is not None and atlas_table is not None:
        tex_rows = rows.tex
        tex = sample_material_textures(atlas, atlas_table, tex_rows, uv,
                                       slots=slots)
        albedo = torch.where(tex.has_base[:, None], tex.base_rgb, albedo)
        emission = emission * torch.where(tex.has_emission[:, None],
                                          tex.emission_rgb, 1.0)
        roughness = roughness * torch.where(tex.has_rm, tex.rough, 1.0)
        metallic = metallic * torch.where(tex.has_rm, tex.metal, 1.0)
        transmission = torch.where(tex.has_transmission, tex.transmission,
                                   transmission)
        clearcoat = torch.where(tex.has_clearcoat, tex.clearcoat, clearcoat)
    return ShadingContext(
        albedo=albedo,
        emission=emission,
        roughness=roughness,
        metallic=metallic,
        transmission=transmission,
        ior=row[..., 10],
        anisotropy=row[..., 11],
        anisotropy_rotation=row[..., 12],
        clearcoat=clearcoat,
        clearcoat_roughness=row[..., 14],
        flags=row[..., 15].to(torch.int32),
        energy=materials.energy,
        energy_avg=materials.energy_avg,
        mat_idx=mat_idx,
        tex_rows=tex_rows,
        energy_avg_row=rows.energy_avg,
    )


@dataclass(frozen=True)
class BSDFSample:
    wi: torch.Tensor     # (R, 3) local
    f: torch.Tensor      # (R, 3)
    pdf: torch.Tensor    # (R,)
    flags: torch.Tensor  # (R,) i32


@dataclass(frozen=True)
class BSDFEval:
    f: torch.Tensor    # (R, 3)
    pdf: torch.Tensor  # (R,)


# ---------------------------------------------------------------------------
# LUT-based energy terms
# ---------------------------------------------------------------------------

def _ior_param(ior):
    return (ior - 1.0) / torch.clamp(ior, min=1e-6)


def _use_rows(ctx, features) -> bool:
    return "tex_rough" not in features and ctx.energy is not None


def _energy_row(ctx, cos):
    """Interpolated (R, 6) per-material energy row at per-lane cos."""
    m, k, w = ctx.energy.shape
    x = torch.clamp(cos * k - 0.5, 0.0, k - 1.0)
    x0 = torch.floor(x)
    f = x - x0
    lin = ctx.mat_idx.long() * k + x0.long()
    return lookup.interp_rows(ctx.energy.reshape(m * k, w), lin, f)


def _orient_cosines(wo_z, wi_z):
    """Flip the (wo, wi) cosine pair into wo's hemisphere."""
    s = torch.where(wo_z < 0.0, -1.0, 1.0)
    return wo_z * s, wi_z * s


def _aniso_amount(ctx, features):
    if ctx is None or features is None or "aniso" not in features:
        return None
    return torch.abs(torch.where((ctx.flags & MAT_ANISOTROPIC) != 0,
                                 ctx.anisotropy, 0.0))


def _sample_E(luts, cos, rough, an):
    e = luts_mod.sample2d(luts.E, cos, rough)
    if an is None:
        return e
    return torch.where(an > 0.0,
                       luts_mod.sample3d(luts.E_aniso, cos, rough, an), e)


def _conductor_multiscatter(luts, rough, wo_z, wi_z, f_avg,
                            ctx=None, features=None):
    """Kulla-Conty multiple-scattering lobe; f_avg (R,) or (R, 3)."""
    wo_z, wi_z = _orient_cosines(wo_z, wi_z)
    if ctx is not None and features is not None and _use_rows(ctx, features):
        e_wo = _energy_row(ctx, wo_z)[..., 0]
        e_wi = _energy_row(ctx, wi_z)[..., 0]
        e_avg = ctx.energy_avg_row[..., 0]
    else:
        an = _aniso_amount(ctx, features)
        e_wo = _sample_E(luts, wo_z, rough, an)
        e_wi = _sample_E(luts, wi_z, rough, an)
        e_avg = luts_mod.sample1d(luts.E_avg, rough)
        if an is not None:
            e_avg = torch.where(
                an > 0.0, luts_mod.sample2d(luts.E_avg_aniso, an, rough), e_avg)
    brdf_ms = (1.0 - e_wo) * (1.0 - e_wi) / (
        np.pi * torch.clamp(1.0 - e_avg, min=1e-5))
    if f_avg.dim() == rough.dim() + 1:
        e_avg = e_avg[..., None]
        brdf_ms = brdf_ms[..., None]
    fresnel_ms = f_avg * f_avg * e_avg / torch.clamp(
        1.0 - f_avg * (1.0 - e_avg), min=1e-5)
    return fresnel_ms * brdf_ms


def _transparent_multiscatter(luts, rough, wo_z, ior, ctx=None, features=None,
                              thin=None):
    """Turquin 1/E_wo energy compensation for the transparent lobe."""
    into = ior >= 1.0
    if ctx is not None and features is not None and _use_rows(ctx, features):
        row = _energy_row(ctx, torch.abs(wo_z))
        e_wo = torch.where(into, row[..., 2], row[..., 3])
        if thin is not None:
            e_wo = torch.where(thin, row[..., 0], e_wo)
    else:
        e_in = luts_mod.sample3d(luts.E_trans_in, torch.abs(wo_z), rough,
                                 _ior_param(ior))
        e_out = luts_mod.sample3d(luts.E_trans_out, torch.abs(wo_z), rough,
                                  1.0 - ior)
        e_wo = torch.where(into, e_in, e_out)
        if thin is not None:
            e_wo = torch.where(
                thin, _sample_E(luts, torch.abs(wo_z), rough,
                                _aniso_amount(ctx, features)), e_wo)
    return 1.0 / torch.clamp(e_wo, min=1e-3)


def _coat_fbar(luts, ctx, wo_z, features=None, coat_smooth=None):
    """Mean coat Fresnel F̄(wo) (exact F(|wo.z|) for smooth coats)."""
    cos = torch.abs(wo_z)
    if features is not None and _use_rows(ctx, features):
        fbar = _energy_row(ctx, cos)[..., 4]
    else:
        fbar = luts_mod.sample2d(luts.F_coat_avg, cos, ctx.clearcoat_roughness)
    if coat_smooth is None:
        coat_smooth = ggx.is_smooth(ctx.coat_alpha)
    return torch.where(coat_smooth,
                       fresnel.fresnel_dielectric(cos, CLEARCOAT_IOR), fbar)


def _coat_multiscatter(luts, ctx, wo_z, features=None):
    """Clearcoat energy compensation F̄(wo)/E_F(wo)."""
    cos = torch.abs(wo_z)
    if features is not None and _use_rows(ctx, features):
        row = _energy_row(ctx, cos)
        f_avg, e_f = row[..., 4], row[..., 5]
    else:
        f_avg = luts_mod.sample2d(luts.F_coat_avg, cos, ctx.clearcoat_roughness)
        e_f = luts_mod.sample2d(luts.E_F_coat, cos, ctx.clearcoat_roughness)
    return f_avg / torch.clamp(e_f, min=1e-4)


def _diffuse_factor(luts, ctx, wo_z, wi_z, features=None):
    """Energy-conserving diffuse attenuation under the dielectric GGX."""
    wo_z, wi_z = _orient_cosines(wo_z, wi_z)
    if features is not None and _use_rows(ctx, features):
        e_ms_wo = _energy_row(ctx, wo_z)[..., 1]
        e_ms_wi = _energy_row(ctx, wi_z)[..., 1]
        e_ms_avg = ctx.energy_avg_row[..., 1]
    else:
        p = _ior_param(ctx.ior)
        e_ms_wo = luts_mod.sample3d(luts.E_ms, wo_z, ctx.roughness, p)
        e_ms_wi = luts_mod.sample3d(luts.E_ms, wi_z, ctx.roughness, p)
        e_ms_avg = luts_mod.sample2d(luts.E_ms_avg, p, ctx.roughness)
        an = _aniso_amount(ctx, features)
        if an is not None:
            on = an > 0.0
            e_ms_wo = torch.where(on, luts_mod.sample4d(
                luts.E_ms_aniso, wo_z, ctx.roughness, p, an), e_ms_wo)
            e_ms_wi = torch.where(on, luts_mod.sample4d(
                luts.E_ms_aniso, wi_z, ctx.roughness, p, an), e_ms_wi)
            e_ms_avg = torch.where(on, luts_mod.sample3d(
                luts.E_ms_avg_aniso, p, ctx.roughness, an), e_ms_avg)
    return (1.0 - e_ms_wo) * (1.0 - e_ms_wi) / (
        np.pi * torch.clamp(1.0 - e_ms_avg, min=1e-5))


def _opaque_dielectric_factor(luts, ctx, wo_z, f_avg, features=None):
    """Blending weight of the dielectric GGX vs the diffuse base."""
    wo_z = torch.abs(wo_z)
    if features is not None and _use_rows(ctx, features):
        row = _energy_row(ctx, wo_z)
        e_wo = row[..., 0]
        e_ms_wo = row[..., 1]
    else:
        p = _ior_param(ctx.ior)
        an = _aniso_amount(ctx, features)
        e_wo = _sample_E(luts, wo_z, ctx.roughness, an)
        e_ms_wo = luts_mod.sample3d(luts.E_ms, wo_z, ctx.roughness, p)
        if an is not None:
            e_ms_wo = torch.where(an > 0.0, luts_mod.sample4d(
                luts.E_ms_aniso, wo_z, ctx.roughness, p, an), e_ms_wo)
    fresnel_ms = f_avg * f_avg * e_wo / torch.clamp(
        1.0 - f_avg * (1.0 - e_wo), min=1e-5)
    return torch.clamp(f_avg * e_ms_wo + fresnel_ms * (1.0 - e_ms_wo),
                       0.0, 0.999)


# ---------------------------------------------------------------------------
# Anisotropy rotation helpers
# ---------------------------------------------------------------------------

def _rotate_xy(v, cos_a, sin_a):
    x = v[..., 0] * cos_a - v[..., 1] * sin_a
    y = v[..., 0] * sin_a + v[..., 1] * cos_a
    return torch.stack([x, y, v[..., 2]], dim=-1)


def _aniso_rotation(ctx):
    rot = torch.where((ctx.flags & MAT_ANISOTROPIC) != 0,
                      ctx.anisotropy_rotation, 0.0) * (2.0 * np.pi)
    return torch.cos(rot), torch.sin(rot)


# ---------------------------------------------------------------------------
# Evaluation (NEE path)
# ---------------------------------------------------------------------------

ALL_FEATURES = frozenset(
    {"metallic", "transparent", "clearcoat", "smooth", "aniso", "thin",
     "tex_rough", "env", "area_lights", "alpha"}
    | {f"texslot{k}" for k in range(6)}
)


def scene_features(materials_host) -> frozenset:
    """Static material-feature analysis for lobe pruning (numpy view of
    the material table); the JAX package's scene_features."""
    m = materials_host
    feats = set()
    has_rm_tex = bool((np.asarray(m.textures)[:, 1] >= 0).any())
    if has_rm_tex:
        feats.add("tex_rough")
    rough = np.asarray(m.roughness)
    if (np.asarray(m.metallic) > 0).any():
        feats.add("metallic")
    if (np.asarray(m.transmission) > 0).any():
        feats.add("transparent")
    if (np.asarray(m.clearcoat) > 0).any():
        feats.add("clearcoat")
        if (np.asarray(m.clearcoat_roughness) ** 2 < 1e-3).any():
            feats.add("smooth")
    if (np.asarray(m.anisotropy) != 0).any():
        feats.add("aniso")
    if ((rough * rough) < 1e-3).any() or has_rm_tex:
        feats.add("smooth")
    if (np.asarray(m.flags) & MAT_THIN).any():
        feats.add("thin")
    return frozenset(feats)


def _zeros(shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def evaluate_plain(ctx: ShadingContext, wo, wi, luts,
                   multiscatter: bool = True,
                   features: frozenset = ALL_FEATURES) -> BSDFEval:
    """`evaluate` in plain PyTorch: what CPU tensors run, and the
    reference the kernel is held to."""
    shape = tuple(wo.shape[:-1])

    if "aniso" in features:
        cos_a, sin_a = _aniso_rotation(ctx)
        wo = _rotate_xy(wo, cos_a, -sin_a)
        wi = _rotate_xy(wi, cos_a, -sin_a)

    # reflection-hemisphere gate (bsdf.metal:200-201)
    valid = (wo[..., 2] >= MIN_COS) & (wi[..., 2] >= MIN_COS)
    alpha = ctx.alpha
    smooth = (ggx.is_smooth(alpha) if "smooth" in features
              else torch.zeros(shape, dtype=torch.bool, device=wo.device))

    m = ctx.metallic
    transparent = (1.0 - m) * ctx.transmission
    opaque = (1.0 - m) * (1.0 - transparent)

    wm = wo + wi
    wm_len = norm(wm, keepdim=True)
    wm = wm / torch.clamp(wm_len, min=1e-20)
    wm = wm * torch.where(wm[..., 2:3] < 0, -1.0, 1.0)
    wm_ok = wm_len[..., 0] > 1e-10
    dot_wo_wm = torch.abs(dot(wo, wm))

    ss = ggx.single_scatter_brdf(alpha, wo, wi, wm)
    ggx_pdf = ggx.pdf(alpha, wo, wm)

    f = _zeros(shape + (3,), wo)
    pdf = _zeros(shape, wo)

    if "metallic" in features:
        f_metal = fresnel.schlick(ctx.albedo, dot_wo_wm) * ss[..., None]
        if multiscatter:
            f_metal = f_metal + _conductor_multiscatter(
                luts, ctx.roughness, wo[..., 2], wi[..., 2],
                fresnel.avg_conductor_fresnel(ctx.albedo),
                ctx=ctx, features=features)
        use_metal = (m > 0.0) & ~smooth & wm_ok
        f = f + torch.where(use_metal[..., None], f_metal * m[..., None], 0.0)
        pdf = pdf + torch.where(use_metal, ggx_pdf * m, 0.0)

    if "transparent" in features:
        f_ss_t = fresnel.fresnel_dielectric(dot(wo, wm), ctx.ior)
        f_trans = torch.broadcast_to((f_ss_t * ss)[..., None], shape + (3,))
        if multiscatter:
            comp = _transparent_multiscatter(
                luts, ctx.roughness, wo[..., 2], ctx.ior, ctx=ctx,
                features=features,
                thin=(ctx.thin if "thin" in features else None))
            f_trans = f_trans * comp[..., None]
        use_trans = (transparent > 0.0) & ~smooth & wm_ok
        f = f + torch.where(use_trans[..., None],
                            f_trans * transparent[..., None], 0.0)
        pdf = pdf + torch.where(use_trans, f_ss_t * ggx_pdf * transparent, 0.0)

    f_avg = fresnel.avg_dielectric_fresnel_fit(ctx.ior)
    bf = _opaque_dielectric_factor(luts, ctx, wo[..., 2], f_avg, features)
    c_diffuse = _diffuse_factor(luts, ctx, wo[..., 2], wi[..., 2], features)
    diffuse_pdf = torch.abs(wi[..., 2]) / np.pi

    f_ss_o = fresnel.fresnel_dielectric(dot_wo_wm, ctx.ior)
    dielectric = f_ss_o * ss
    if multiscatter:
        dielectric = dielectric + _conductor_multiscatter(
            luts, ctx.roughness, wo[..., 2], wi[..., 2], f_avg,
            ctx=ctx, features=features)
    f_opaque_rough = dielectric[..., None] + ctx.albedo * c_diffuse[..., None]
    pdf_opaque_rough = ggx_pdf * bf + diffuse_pdf * (1.0 - bf)
    f_opaque_smooth = ctx.albedo * c_diffuse[..., None]
    pdf_opaque_smooth = diffuse_pdf * (1.0 - bf)

    f_opaque = torch.where(smooth[..., None], f_opaque_smooth, f_opaque_rough)
    pdf_opaque = torch.where(smooth, pdf_opaque_smooth, pdf_opaque_rough)
    use_opaque = opaque > 0.0
    f = f + torch.where(use_opaque[..., None], f_opaque * opaque[..., None], 0.0)
    pdf = pdf + torch.where(use_opaque, pdf_opaque * opaque, 0.0)

    if "clearcoat" in features:
        coat_alpha = ctx.coat_alpha
        coat_smooth = ggx.is_smooth(coat_alpha)
        coat_ss = ggx.single_scatter_brdf(coat_alpha, wo, wi, wm)
        coat_f_ss = fresnel.fresnel_dielectric(dot(wo, wm), CLEARCOAT_IOR)
        coat_pdf = ggx.pdf(coat_alpha, wo, wm)
        # base dimming by the coat's marginal pick probability c·F̄(wo)
        coat_dim = ctx.clearcoat * _coat_fbar(luts, ctx, wo[..., 2],
                                              features, coat_smooth)
        coat_add = ctx.clearcoat * torch.where(coat_smooth | ~wm_ok, 0.0,
                                               coat_f_ss)
        if multiscatter:
            coat_ss = coat_ss * _coat_multiscatter(luts, ctx, wo[..., 2],
                                                   features)
        f = f * (1.0 - coat_dim[..., None]) + torch.where(
            (coat_add > 0)[..., None],
            coat_ss[..., None] * coat_add[..., None], 0.0)
        pdf = pdf * (1.0 - coat_dim) + torch.where(
            coat_add > 0, coat_pdf * coat_add, 0.0)

    f = torch.where(valid[..., None], f, 0.0)
    pdf = torch.where(valid, pdf, 0.0)
    return BSDFEval(f=f, pdf=pdf)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _flag(v, shape, like):
    return torch.full(shape, v, dtype=torch.int32, device=like.device)


def sample_plain(ctx: ShadingContext, wo, r4, rc, luts,
                 multiscatter: bool = True,
                 features: frozenset = ALL_FEATURES,
                 mixture_pdf: bool = True) -> BSDFSample:
    """`sample` in plain PyTorch: what CPU tensors run, and the reference
    the kernel is held to (see the JAX `sample` docstring for the
    mixture-pdf estimator)."""
    shape = tuple(wo.shape[:-1])
    dev = wo.device
    wo_in = wo
    no = torch.zeros(shape, dtype=torch.bool, device=dev)

    has_smooth = "smooth" in features
    has_metal = "metallic" in features
    has_trans = "transparent" in features
    has_coat = "clearcoat" in features

    if "aniso" in features:
        cos_a, sin_a = _aniso_rotation(ctx)
        wo = _rotate_xy(wo, cos_a, -sin_a)

    alpha = ctx.alpha
    smooth = ggx.is_smooth(alpha) if has_smooth else no
    thin = ctx.thin if "thin" in features else no

    m = ctx.metallic
    t = ctx.transmission
    c = ctx.clearcoat
    zero3 = torch.zeros_like(wo)
    up = zero3 + const_like((0.0, 0.0, 1.0), zero3)

    # lobe-selection probabilities (bsdf.metal:229-252)
    if has_coat:
        coat_alpha = ctx.coat_alpha
        coat_smooth = ggx.is_smooth(coat_alpha)
        wm_coat = torch.where(coat_smooth[..., None], up,
                              ggx.sample_vmdf(coat_alpha, wo, rc))
        p_coat = c * fresnel.fresnel_dielectric(
            torch.abs(dot(wo, wm_coat)), CLEARCOAT_IOR)
        p_coat = torch.where(c > 0.0, p_coat, 0.0)
    else:
        p_coat = _zeros(shape, wo)
    p_metal = p_coat + (1.0 - p_coat) * m
    p_transparent = p_coat + (1.0 - p_coat) * (m + (1.0 - m) * t)

    rw = r4[..., 3]
    sel_coat = (rw < p_coat) if has_coat else no
    sel_metal = ~sel_coat & (rw < p_metal) if has_metal else no
    sel_trans = (~sel_coat & ~sel_metal & (rw < p_transparent)
                 if has_trans else no)

    u2 = r4[..., :2]
    rz = r4[..., 2]

    wm = ggx.sample_vmdf(alpha, wo, u2)
    dot_wo_wm = dot(wo, wm)
    wi_spec_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)

    if has_metal:
        wi_metal_r = ggx.reflect(-wo, wm)
        bad_metal = wo[..., 2] * wi_metal_r[..., 2] < 0.0
        f_metal_r = fresnel.schlick(ctx.albedo, torch.abs(dot_wo_wm)) * \
            ggx.single_scatter_brdf(alpha, wo, wi_metal_r, wm)[..., None]
        if multiscatter:
            f_metal_r = f_metal_r + _conductor_multiscatter(
                luts, ctx.roughness, wo[..., 2], wi_metal_r[..., 2],
                fresnel.avg_conductor_fresnel(ctx.albedo),
                ctx=ctx, features=features)
        pdf_metal_r = ggx.pdf(alpha, wo, wm)
        f_metal_s = fresnel.schlick(ctx.albedo, wo[..., 2]) / torch.clamp(
            torch.abs(wo[..., 2]), min=1e-20)[..., None]

        wi_metal = torch.where(smooth[..., None], wi_spec_mirror, wi_metal_r)
        f_metal = torch.where(smooth[..., None], f_metal_s,
                              torch.where(bad_metal[..., None], 0.0, f_metal_r))
        pdf_metal = torch.where(smooth, 1.0,
                                torch.where(bad_metal, 0.0, pdf_metal_r))
        flags_metal = torch.where(
            smooth, _flag(SAMPLE_REFLECTED | SAMPLE_SPECULAR, shape, wo),
            _flag(SAMPLE_REFLECTED | SAMPLE_GLOSSY, shape, wo))

    if has_trans:
        ior_t = torch.where((wo[..., 2] < 0.0) & ~thin, 1.0 / ctx.ior, ctx.ior)
        # rough path
        f_ss = fresnel.fresnel_dielectric(torch.abs(dot_wo_wm), ior_t)
        reflecting = rz < f_ss
        wi_refl = ggx.reflect(-wo, wm)
        wi_thin = wi_refl * const_like((1.0, 1.0, -1.0), wi_refl)
        wm_signed = wm * torch.where(dot_wo_wm[..., None] < 0, -1.0, 1.0)
        wi_refr = ggx.refract(-wo, wm_signed, 1.0 / ior_t)
        wi_tr = torch.where(reflecting[..., None], wi_refl,
                            torch.where(thin[..., None], wi_thin, wi_refr))
        same_side = wo[..., 2] * wi_tr[..., 2] > 0.0
        bad_tr = torch.where(reflecting, ~same_side, same_side)
        ss_tr = ggx.single_scatter_brdf(alpha, wo, wi_tr, wm)
        pdf_r = ggx.pdf(alpha, wo, wm)
        dot_i = dot(wi_tr, wm)
        denom = (dot_i * ior_t + dot_wo_wm) ** 2
        dwm_dwi = torch.abs(dot_i) / torch.clamp(denom, min=1e-20)
        btdf = ggx.mdf(alpha, wm) * ggx.g(alpha, wo, wi_tr) * torch.abs(
            dot_i * dot_wo_wm
            / (wi_tr[..., 2] * wo[..., 2] * torch.clamp(denom, min=1e-20)))
        pdf_t = ggx.vmdf(alpha, wo, wm) * dwm_dwi
        k = torch.where(reflecting, f_ss, 1.0 - f_ss)
        base = torch.where(reflecting, ss_tr, torch.where(thin, ss_tr, btdf))
        f_tr_rough = k * base
        color_tr = torch.where(reflecting[..., None],
                               torch.ones_like(ctx.albedo), ctx.albedo)
        if multiscatter:
            f_tr_rough = f_tr_rough * _transparent_multiscatter(
                luts, ctx.roughness, wo[..., 2], ior_t, ctx=ctx,
                features=features,
                thin=(thin if "thin" in features else None))
        pdf_tr_rough = k * torch.where(reflecting | thin, pdf_r, pdf_t)

        # smooth path (bsdf.metal:586-617)
        f_ss_smooth = fresnel.fresnel_dielectric(torch.abs(wo[..., 2]), ior_t)
        refl_s = rz < f_ss_smooth
        n_side = torch.cat([torch.zeros(shape + (2,), device=dev),
                            torch.where(wo[..., 2] < 0, -1.0, 1.0)[..., None]],
                           dim=-1)
        wi_tr_smooth_t = torch.where(thin[..., None], -wo,
                                     ggx.refract(-wo, n_side, 1.0 / ior_t))
        wi_tr_smooth = torch.where(refl_s[..., None], wi_spec_mirror,
                                   wi_tr_smooth_t)
        bad_tr_smooth = ~refl_s & (torch.abs(wi_tr_smooth[..., 2]) < 1e-9)
        pdf_tr_smooth = torch.where(refl_s, f_ss_smooth, 1.0 - f_ss_smooth)
        color_smooth = torch.where(refl_s[..., None],
                                   torch.ones_like(ctx.albedo), ctx.albedo)
        f_tr_smooth = pdf_tr_smooth / torch.clamp(
            torch.abs(wi_tr_smooth[..., 2]), min=1e-20)

        wi_trans = torch.where(smooth[..., None], wi_tr_smooth, wi_tr)
        f_trans = torch.where(
            smooth[..., None],
            torch.where(bad_tr_smooth[..., None], 0.0,
                        f_tr_smooth[..., None] * color_smooth),
            torch.where(bad_tr[..., None], 0.0,
                        f_tr_rough[..., None] * color_tr))
        pdf_trans = torch.where(
            smooth, torch.where(bad_tr_smooth, 0.0, pdf_tr_smooth),
            torch.where(bad_tr, 0.0, pdf_tr_rough))
        transmitted = torch.where(smooth, ~refl_s, ~reflecting)
        flags_trans = (
            torch.where(transmitted, _flag(SAMPLE_TRANSMITTED, shape, wo),
                        _flag(SAMPLE_REFLECTED, shape, wo))
            | torch.where(smooth, _flag(SAMPLE_SPECULAR, shape, wo),
                          _flag(SAMPLE_GLOSSY, shape, wo)))

    # opaque dielectric
    f_avg = fresnel.avg_dielectric_fresnel_fit(ctx.ior)
    bf = _opaque_dielectric_factor(luts, ctx, wo[..., 2], f_avg, features)
    pick_dielectric = rz < bf

    f_ss_os = fresnel.fresnel_dielectric(torch.abs(wo[..., 2]), ctx.ior)
    f_op_d_smooth = f_ss_os / torch.clamp(torch.abs(wo[..., 2]), min=1e-20)
    pdf_op_d_smooth = bf

    f_ss_or = fresnel.fresnel_dielectric(torch.abs(dot_wo_wm), ctx.ior)
    wi_op_r = ggx.reflect(-wo, wm)
    bad_op = torch.sum(wm * wm, dim=-1) < 1e-12
    diel_rough = f_ss_or * ggx.single_scatter_brdf(alpha, wo, wi_op_r, wm)
    if multiscatter:
        diel_rough = diel_rough + _conductor_multiscatter(
            luts, ctx.roughness, wo[..., 2], wi_op_r[..., 2], f_avg,
            ctx=ctx, features=features)
    pdf_op_d_rough = ggx.pdf(alpha, wo, wm) * bf

    wi_op_d = torch.where(smooth[..., None], wi_spec_mirror, wi_op_r)
    f_op_d = torch.where(
        smooth[..., None], f_op_d_smooth[..., None],
        torch.where(bad_op[..., None], 0.0, diel_rough[..., None]),
    ) * torch.ones_like(ctx.albedo)
    pdf_op_d = torch.where(smooth, pdf_op_d_smooth,
                           torch.where(bad_op, 0.0, pdf_op_d_rough))
    flags_op_d = torch.where(
        smooth, _flag(SAMPLE_REFLECTED | SAMPLE_SPECULAR, shape, wo),
        _flag(SAMPLE_REFLECTED | SAMPLE_GLOSSY, shape, wo))

    # diffuse sub-lobe
    wi_diff = smp.sample_cosine_hemisphere(u2)
    wi_diff = wi_diff * torch.where(wo[..., 2:3] < 0.0, -1.0, 1.0)
    c_diffuse = _diffuse_factor(luts, ctx, wo[..., 2], wi_diff[..., 2],
                                features)
    f_diff = ctx.albedo * c_diffuse[..., None]
    pdf_diff = torch.abs(wi_diff[..., 2]) / np.pi * (1.0 - bf)
    flags_diff = (_flag(SAMPLE_REFLECTED | SAMPLE_DIFFUSE, shape, wo)
                  | torch.where((ctx.flags & MAT_EMISSIVE) != 0,
                                _flag(SAMPLE_EMITTED, shape, wo),
                                _flag(0, shape, wo)))

    wi_opaque = torch.where(pick_dielectric[..., None], wi_op_d, wi_diff)
    f_opaque = torch.where(pick_dielectric[..., None], f_op_d, f_diff)
    pdf_opaque = torch.where(pick_dielectric, pdf_op_d, pdf_diff)
    flags_opaque = torch.where(pick_dielectric, flags_op_d, flags_diff)

    if has_coat:
        f_coat_ss = fresnel.fresnel_dielectric(
            torch.abs(dot(wo, wm_coat)), CLEARCOAT_IOR)
        wi_coat_r = ggx.reflect(-wo, wm_coat)
        bad_coat = wo[..., 2] * wi_coat_r[..., 2] < 0.0
        f_coat_rough = f_coat_ss * ggx.single_scatter_brdf(
            coat_alpha, wo, wi_coat_r, wm_coat)
        if multiscatter:
            f_coat_rough = f_coat_rough * _coat_multiscatter(
                luts, ctx, wo[..., 2], features)
        pdf_coat_rough = f_coat_ss * ggx.pdf(coat_alpha, wo, wm_coat)
        f_coat_s = fresnel.fresnel_dielectric(wo[..., 2], CLEARCOAT_IOR)

        wi_coat = torch.where(coat_smooth[..., None], wi_spec_mirror, wi_coat_r)
        f_coat = torch.where(
            coat_smooth, f_coat_s / torch.clamp(torch.abs(wo[..., 2]), min=1e-20),
            torch.where(bad_coat, 0.0, f_coat_rough))
        pdf_coat = torch.where(coat_smooth, f_coat_s,
                               torch.where(bad_coat, 0.0, pdf_coat_rough))
        flags_coat = torch.where(
            coat_smooth, _flag(SAMPLE_REFLECTED | SAMPLE_SPECULAR, shape, wo),
            _flag(SAMPLE_REFLECTED | SAMPLE_GLOSSY, shape, wo))

    # select lobe
    wi, f, pdf, flags = wi_opaque, f_opaque, pdf_opaque, flags_opaque
    if has_trans:
        wi = torch.where(sel_trans[..., None], wi_trans, wi)
        f = torch.where(sel_trans[..., None], f_trans, f)
        pdf = torch.where(sel_trans, pdf_trans, pdf)
        flags = torch.where(sel_trans, flags_trans, flags)
    if has_metal:
        wi = torch.where(sel_metal[..., None], wi_metal, wi)
        f = torch.where(sel_metal[..., None], f_metal, f)
        pdf = torch.where(sel_metal, pdf_metal, pdf)
        flags = torch.where(sel_metal, flags_metal, flags)
    if has_coat:
        wi = torch.where(sel_coat[..., None], wi_coat, wi)
        f = torch.where(sel_coat[..., None], f_coat[..., None].expand(shape + (3,)), f)
        pdf = torch.where(sel_coat, pdf_coat, pdf)
        flags = torch.where(sel_coat, flags_coat, flags)

    # zero-pdf lanes are dead samples
    dead = pdf <= 0.0
    flags = torch.where(dead, 0, flags).to(torch.int32)
    f = torch.where(dead[..., None], 0.0, f)

    if "aniso" in features:
        wi = _rotate_xy(wi, cos_a, sin_a)

    if mixture_pdf:
        ev = evaluate_plain(ctx, wo_in, wi, luts, multiscatter=multiscatter,
                            features=features)
        keep = (dead | ((flags & SAMPLE_SPECULAR) != 0)
                | (wo_in[..., 2] * wi[..., 2] <= 0.0) | (ev.pdf <= 0.0))
        f = torch.where(keep[..., None], f, ev.f)
        pdf = torch.where(keep, pdf, ev.pdf)
    return BSDFSample(wi=wi, f=f, pdf=pdf, flags=flags)


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/bsdf_shade.cu) and the dispatch
# ---------------------------------------------------------------------------

# The features the BSDF reads, each the kernel's bit of `mode`
FEATURE_BITS = {"metallic": 1, "transparent": 2, "clearcoat": 4,
                "smooth": 8, "aniso": 16, "thin": 32, "tex_rough": 64}
MODE_MULTISCATTER = 256
MODE_MIXTURE_PDF = 512
MODE_ROWS = 1024      # the per-material energy rows (`_use_rows`)

# Kernel launches per entry, counted where the wrappers launch
LAUNCHES = {"sample": 0, "evaluate": 0}

_CTX_FIELDS = (("albedo", 3), ("roughness", 1), ("metallic", 1),
               ("transmission", 1), ("ior", 1), ("anisotropy", 1),
               ("anisotropy_rotation", 1), ("clearcoat", 1),
               ("clearcoat_roughness", 1))


def feature_mask(features) -> int:
    """The kernel's bits of the features the BSDF reads."""
    return sum(b for name, b in FEATURE_BITS.items() if name in features)


def mask_features(mask: int) -> frozenset:
    """The features whose bits `mask` holds (`feature_mask`'s inverse on
    the features the BSDF reads)."""
    return frozenset(name for name, b in FEATURE_BITS.items() if mask & b)


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsdf_shade_launch.restype = i
    lib.bsdf_shade_launch.argtypes = [i, i, i, p, i, p]
    lib.bsdf_shade_error_string.restype = ctypes.c_char_p
    lib.bsdf_shade_error_string.argtypes = [i]


def _table(name, t, dev):
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 table on "
                         f"{dev}")
    return t.data_ptr()


def _launch(entry: int, ctx: ShadingContext, wo, a, b, luts, mode: int):
    """One launch of csrc/bsdf_shade.cu over the lanes of `wo` (n, 3):
    entry 0 samples (a = r4 (n, 4), b = rc (n, 2); returns wi, f, pdf,
    flags), entry 1 evaluates (a = wi (n, 3); returns f, pdf). Outputs
    are allocated here; the kernel allocates nothing and does not
    synchronise."""
    from platinum_tpu_torch.ops.packet_trace import lane_field, load_library

    dev = wo.device
    if wo.dim() != 2:
        raise ValueError(f"wo must be (n, 3), got {tuple(wo.shape)}")
    n = wo.shape[0]
    words = []
    for name, k in _CTX_FIELDS:
        words += lane_field(name, getattr(ctx, name), n, k, dev)
    rows = bool(mode & MODE_ROWS)
    if rows:
        words += lane_field("energy_avg_row", ctx.energy_avg_row, n, 4, dev)
    else:
        words += [0, 0, 0]
    words += lane_field("flags", ctx.flags, n, 1, dev, torch.int32)
    if rows:
        words += lane_field("mat_idx", ctx.mat_idx, n, 1, dev, torch.int32)
    else:
        words += [0, 0, 0]
    words += lane_field("wo", wo, n, 3, dev)
    if entry == 0:
        words += (lane_field("r4", a, n, 4, dev)
                  + lane_field("rc", b, n, 2, dev))
    else:
        words += lane_field("wi", a, n, 3, dev) + [0, 0, 0]
    if rows:
        m, k, w = ctx.energy.shape
        if w != 6:
            raise ValueError(f"energy rows must be (M, K, 6), got "
                             f"{tuple(ctx.energy.shape)}")
        words += [_table("energy", ctx.energy, dev), k, m * k]
    else:
        words += [0, 0, 0]
    for f in dataclasses.fields(luts_mod.Luts):
        if rows:
            words += [0, 1, 1, 1, 1]
            continue
        if luts is None:
            raise ValueError("the LUT path needs the Luts")
        t = getattr(luts, f.name)
        words += [_table(f.name, t, dev)] + list(t.shape) + [1] * (
            4 - t.dim())
    f_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    if entry == 0:
        wi = torch.empty((n, 3), dtype=torch.float32, device=dev)
        flags = torch.empty((n,), dtype=torch.int32, device=dev)
        words += [wi.data_ptr(), f_out.data_ptr(), pdf.data_ptr(),
                  flags.data_ptr()]
    else:
        words += [0, f_out.data_ptr(), pdf.data_ptr(), 0]
    if n:
        lib = load_library("bsdf_shade", _declare)
        args = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(dev):
            rc = lib.bsdf_shade_launch(
                entry, n, mode, args, len(words),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                "bsdf_shade launch failed: "
                f"{lib.bsdf_shade_error_string(rc).decode()} ({rc})")
        LAUNCHES["sample" if entry == 0 else "evaluate"] += 1
        telemetry.count("bsdf.kernel_lanes", n)
    return (wi, f_out, pdf, flags) if entry == 0 else (f_out, pdf)


def _mode(ctx, features, multiscatter, mixture_pdf=False) -> int:
    return (feature_mask(features)
            | (MODE_MULTISCATTER if multiscatter else 0)
            | (MODE_MIXTURE_PDF if mixture_pdf else 0)
            | (MODE_ROWS if _use_rows(ctx, features) else 0))


def sample(ctx: ShadingContext, wo, r4, rc, luts, multiscatter: bool = True,
           features: frozenset = ALL_FEATURES,
           mixture_pdf: bool = True) -> BSDFSample:
    """Importance-sample the BSDF: wi, f, pdf and flags for each lane of
    `wo` (n, 3) from r4 (n, 4) and rc (n, 2). CUDA tensors launch the
    kernel (csrc/bsdf_shade.cu) or raise; CPU tensors run
    `sample_plain`."""
    telemetry.count("bsdf.lanes", wo.shape[:-1].numel())
    if not wo.is_cuda:
        return sample_plain(ctx, wo, r4, rc, luts, multiscatter=multiscatter,
                            features=features, mixture_pdf=mixture_pdf)
    wi, f, pdf, flags = _launch(
        0, ctx, wo, r4, rc, luts,
        _mode(ctx, features, multiscatter, mixture_pdf))
    return BSDFSample(wi=wi, f=f, pdf=pdf, flags=flags)


def evaluate(ctx: ShadingContext, wo, wi, luts, multiscatter: bool = True,
             features: frozenset = ALL_FEATURES) -> BSDFEval:
    """f and pdf of the BSDF for each lane's (wo, wi), both (n, 3). CUDA
    tensors launch the kernel (csrc/bsdf_shade.cu) or raise; CPU tensors
    run `evaluate_plain`."""
    telemetry.count("bsdf.lanes", wo.shape[:-1].numel())
    if not wo.is_cuda:
        return evaluate_plain(ctx, wo, wi, luts, multiscatter=multiscatter,
                              features=features)
    f, pdf = _launch(1, ctx, wo, wi, None, luts,
                     _mode(ctx, features, multiscatter))
    return BSDFEval(f=f, pdf=pdf)


def emitted_radiance(ctx: ShadingContext, wo, luts,
                     features: frozenset = ALL_FEATURES) -> torch.Tensor:
    """Deterministic expected emission on hit, scaled by the probability
    of the opaque-diffuse path."""
    if "clearcoat" in features:
        p_coat = ctx.clearcoat * _coat_fbar(luts, ctx, wo[..., 2], features)
    else:
        p_coat = 0.0
    p_opaque = (1.0 - p_coat) * (1.0 - ctx.metallic) * (1.0 - ctx.transmission)
    is_emissive = (ctx.flags & MAT_EMISSIVE) != 0
    return torch.where(is_emissive[..., None],
                       ctx.emission * p_opaque[..., None], 0.0)


def wants_nee(ctx: ShadingContext) -> torch.Tensor:
    """NEE is skipped for purely specular contexts (kernel.metal:585)."""
    return (ctx.roughness > 0.0) | (ctx.metallic + ctx.transmission < 1.0)
