"""platinum_tpu_torch BSDF vs the JAX package's: evaluate, sample and
emitted_radiance on the same seeded ShadingContext inputs, for the
diffuse (opaque dielectric), dielectric (transmissive) and metal lobes,
through the LUTs and through per-material energy rows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.models import bsdf as jbsdf
from platinum_tpu.ops import luts as jluts
from platinum_tpu_torch.models import bsdf as tbsdf
from platinum_tpu_torch.ops import luts as tluts

torch.set_num_threads(1)
N = 2048
RTOL, ATOL = 1e-5, 1e-6

LOBES = {
    # name: (metallic, transmission, feature set)
    "diffuse": (0.0, 0.0, frozenset()),
    "dielectric": (0.0, 1.0, frozenset({"transparent"})),
    "metal": (1.0, 0.0, frozenset({"metallic"})),
}


def _directions(rng, n, lower_frac):
    """Unit vectors away from grazing (|z| >= 0.05); `lower_frac` of them
    below the horizon."""
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    flip = rng.random(n) < lower_frac
    v[flip, 2] *= -1.0
    return v.astype(np.float32)


def _inputs(lobe, rows, seed):
    rng = np.random.default_rng(seed)
    metal, trans, feats = LOBES[lobe]
    m = 4
    ctx = dict(
        albedo=rng.uniform(0.05, 0.95, (N, 3)),
        emission=rng.uniform(0.0, 3.0, (N, 3)),
        roughness=rng.uniform(0.15, 1.0, N),
        metallic=np.full(N, metal),
        transmission=np.full(N, trans),
        ior=rng.uniform(1.2, 1.8, N),
        anisotropy=np.zeros(N),
        anisotropy_rotation=np.zeros(N),
        clearcoat=np.zeros(N),
        clearcoat_roughness=np.zeros(N),
    )
    ctx = {k: v.astype(np.float32) for k, v in ctx.items()}
    ctx["flags"] = np.where(rng.random(N) < 0.3, 2, 0).astype(np.int32)
    if rows:
        # smooth in cos, like the baked rows (random jumps between bins
        # would amplify ulp-level cosine differences into the result)
        grid = (np.arange(64) + 0.5) / 64
        a, b = rng.uniform(0.3, 0.6, (2, m, 1, 6))
        ctx["energy"] = (a + b * grid[None, :, None]).astype(np.float32)
        ctx["energy_avg"] = rng.uniform(0.3, 0.9, (m, 4)).astype(np.float32)
        ctx["mat_idx"] = rng.integers(0, m, N).astype(np.int32)
        ctx["energy_avg_row"] = ctx["energy_avg"][ctx["mat_idx"]]
    wo = _directions(rng, N, 0.3 if trans > 0 else 0.0)
    wi = _directions(rng, N, 0.2)
    r4 = rng.random((N, 4), dtype=np.float32)
    # keep the VNDF disk draw off the rim: there the sampled normal's z
    # is sqrt(1 - |p|^2) of a vanishing argument and ulp-level sin/cos
    # differences between the two math libraries grow without bound
    r4[:, 0] *= 0.9
    rc = rng.random((N, 2), dtype=np.float32)
    return ctx, feats, wo, wi, r4, rc


def _contexts(ctx):
    j = jbsdf.ShadingContext(**{k: jnp.asarray(v) for k, v in ctx.items()})
    t = tbsdf.ShadingContext(**{k: torch.from_numpy(v) for k, v in ctx.items()})
    return j, t


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


CASES = [(lobe, rows) for lobe in sorted(LOBES) for rows in (False, True)]


@pytest.mark.parametrize("lobe,rows", CASES)
def test_evaluate_matches_jax(lobe, rows):
    ctx, feats, wo, wi, _, _ = _inputs(lobe, rows, seed=1)
    jc, tc = _contexts(ctx)
    ref = jbsdf.evaluate(jc, jnp.asarray(wo), jnp.asarray(wi),
                         luts=jluts.get_luts(), features=feats)
    got = tbsdf.evaluate(tc, torch.from_numpy(wo), torch.from_numpy(wi),
                         tluts.load_luts("cpu"), features=feats)
    assert float(np.asarray(ref.pdf).max()) > 0.0
    _close(got.f, ref.f, "f")
    _close(got.pdf, ref.pdf, "pdf")


@pytest.mark.parametrize("lobe,rows", CASES)
def test_sample_matches_jax(lobe, rows):
    ctx, feats, wo, _, r4, rc = _inputs(lobe, rows, seed=2)
    jc, tc = _contexts(ctx)
    ref = jbsdf.sample(jc, jnp.asarray(wo), jnp.asarray(r4), jnp.asarray(rc),
                       luts=jluts.get_luts(), features=feats)
    got = tbsdf.sample(tc, torch.from_numpy(wo), torch.from_numpy(r4),
                       torch.from_numpy(rc), tluts.load_luts("cpu"),
                       features=feats)
    assert np.array_equal(got.flags.numpy(), np.asarray(ref.flags))
    _close(got.wi, ref.wi, "wi")
    _close(got.f, ref.f, "f")
    _close(got.pdf, ref.pdf, "pdf")


@pytest.mark.parametrize("lobe", sorted(LOBES))
def test_emitted_radiance_matches_jax(lobe):
    ctx, feats, wo, _, _, _ = _inputs(lobe, False, seed=3)
    jc, tc = _contexts(ctx)
    ref = jbsdf.emitted_radiance(jc, jnp.asarray(wo), features=feats)
    got = tbsdf.emitted_radiance(tc, torch.from_numpy(wo), None,
                                 features=feats)
    _close(got, ref, "Le")
    assert np.array_equal(tbsdf.wants_nee(tc).numpy(),
                          np.asarray(jbsdf.wants_nee(jc)))


def test_scene_features_match_jax():
    rng = np.random.default_rng(4)

    @dataclasses.dataclass
    class Host:
        metallic: np.ndarray
        transmission: np.ndarray
        clearcoat: np.ndarray
        clearcoat_roughness: np.ndarray
        anisotropy: np.ndarray
        roughness: np.ndarray
        flags: np.ndarray
        textures: np.ndarray

    for _ in range(8):
        h = Host(*(np.where(rng.random(3) < 0.5, 0.0, rng.random(3))
                   for _ in range(6)),
                 flags=rng.integers(0, 16, 3), textures=rng.integers(-1, 2, (3, 6)))
        assert tbsdf.scene_features(h) == jbsdf.scene_features(h)
