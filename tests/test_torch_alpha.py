"""Alpha cutout in the port against the JAX package, on the CPU.

The `cutout_shadows` golden scene (tests/test_golden.py:70-117, built by
tests/alpha_scenes.py) at 24x24 and 2 spp through the packet tracer
(flattened with accel_min_tris=1: JAX's kernel in interpret mode, the
port's plain version), through it with compact=True and spp_batch=16
(9,216 lanes, so the static plan compacts), and through the brute tracer.
Each is held to JAX's render_step_n by the bars of
tests/test_torch_slice.py (per pixel rtol = atol = 2e-3 on >= 99.5% of
pixels, the means to 1e-3 relative). Under alpha no any-hit wave is
traced: the port's tracer pair is given an any-hit half that raises.

Also: `_alpha_value` bitwise JAX's on seeded (material, uv) pairs; the
sampler's state after every bounce of a sample bitwise JAX's (Halton's
dimension, PCG4D's four planes, the Z-sampler's dimension: one draw per
path hop before its trace, one per shadow hop after it). The Renderer
on a cut-out Cornell box is in tests/test_torch_renderer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpha_scenes import cutout_scene
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3

CUTOUT = dict(width=24, height=24, max_bounces=4, kernel="mis",
              sampler="halton")
CONFIGS = {
    "packet": (dict(CUTOUT, spp=2, tracer="packet"), 1),
    "packet_compact": (dict(CUTOUT, spp=16, spp_batch=16, compact=True,
                            tracer="packet"), 1),
    "brute": (dict(CUTOUT, spp=2, tracer="brute"), 32),
}


def hold(img, ref, name):
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img.mean() / ref.mean() - 1.0)
    print(f"{name}: {int((~close).sum())} of {close.size} pixels outside "
          f"rtol={PIX_RTOL} atol={PIX_ATOL}; mean {img.mean():.6f} vs "
          f"{ref.mean():.6f} (rel {rel:.2e})")
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert rel <= MEAN_RTOL


def _no_any_hit(flat, settings):
    """The port's tracer pair with an any-hit half that fails the test."""
    trace_closest, _ = integrator.make_tracers(flat, settings)

    def trace_any(*args, **kw):
        raise AssertionError("an any-hit wave was traced under alpha")

    return trace_closest, trace_any


def render_both(scene, cam, kw, accel_min_tris):
    """JAX's and the port's render_step_n on the JAX flatten."""
    jset = JSettings(**kw)
    jflat = jflatten(scene, cam, jset, accel_min_tris=accel_min_tris)
    feats = janalyze(jflat)
    n = jset.num_pixels
    ref = np.asarray(jintegrator.render_step_n(
        jflat, jset, jnp.zeros((n, 3)), jnp.int32(0), kw["spp"],
        features=feats))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    settings = RenderSettings(**kw)
    assert "alpha" in analyze_features(flat) and "alpha" in feats
    img = integrator.render_step_n(
        flat, settings, torch.zeros((n, 3)), 0, kw["spp"],
        features=analyze_features(flat),
        tracers=_no_any_hit(flat, settings)).numpy()
    return img, ref, flat


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cutout_render_matches_jax(name):
    kw, min_tris = CONFIGS[name]
    scene, cam = cutout_scene("platinum_tpu")
    img, ref, flat = render_both(scene, cam, kw, min_tris)
    hold(img, ref, f"cutout {name}")
    assert (flat.wbvh_nodes is not None) == (kw["tracer"] == "packet")
    if kw.get("compact"):
        n = kw["spp_batch"] * kw["width"] * kw["height"]
        assert len(integrator._compaction_plan(n, RenderSettings(**kw))) > 1
    # the checker's shadow and the quad itself: neither black nor flat
    assert ref.mean() > 0.05 and ref.std() > 0.05


def test_alpha_value_is_jax_bitwise():
    """Opacity at seeded hits: every material of the cutout and the
    checker-column scenes, uvs across texel edges and outside [0, 1]."""
    from alpha_scenes import checker_columns

    for make in (cutout_scene, checker_columns):
        scene, cam = make("platinum_tpu")
        jflat = jflatten(scene, cam, JSettings(width=8, height=8))
        flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
        rng = np.random.default_rng(5)
        n_mat = jflat.materials.packed.shape[0]
        mat = rng.integers(0, n_mat, 20_000).astype(np.int32)
        uv = rng.uniform(-2, 3, (20_000, 2)).astype(np.float32)
        uv[:2000] = np.round(uv[:2000] * 32) / 32     # texel edges
        ref = np.asarray(jintegrator._alpha_value(
            jflat, jnp.asarray(mat), jnp.asarray(uv)))
        got = integrator._alpha_value(flat, torch.from_numpy(mat),
                                      torch.from_numpy(uv)).numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
        assert ((ref > 0) & (ref < 1)).any() and (ref == 0).any()


def _planes(stream):
    return [np.asarray(getattr(stream, f)).astype(np.uint32)
            for f in ("x", "y", "z", "w")]


@pytest.mark.parametrize("sampler", ["halton", "pcg4d", "z"])
def test_stream_state_after_each_bounce_is_jax_bitwise(sampler):
    """One sample of the cutout scene (brute tracer) bounce by bounce:
    the stream after each bounce bitwise JAX's, and the radiance within
    the slice's per-pixel bar."""
    kw = dict(CUTOUT, spp=1, sampler=sampler)
    scene, cam = cutout_scene("platinum_tpu")
    jset = JSettings(**kw)
    jflat = jflatten(scene, cam, jset)
    feats = janalyze(jflat)
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    settings = RenderSettings(**kw)
    jstate = jintegrator.init_path_state(jflat, jset, jnp.int32(0))
    state = integrator.init_path_state(flat, settings, 0)
    jbody = jax.jit(jintegrator.make_bounce_body(jflat, jset, feats))
    body = integrator.make_bounce_body(flat, settings,
                                       analyze_features(flat))
    for _ in range(kw["max_bounces"]):
        jstate, state = jbody(jstate), body(state)
        js, ts = jstate["stream"], state["stream"]
        if sampler == "pcg4d":
            for a, b in zip(_planes(js), _planes(ts)):
                assert np.array_equal(a, b)
        else:
            assert int(js.dim) == ts.dim
        assert np.array_equal(np.asarray(jstate["active"]),
                              state["active"].numpy())
        assert np.isclose(state["L"].numpy(), np.asarray(jstate["L"]),
                          rtol=PIX_RTOL, atol=PIX_ATOL).all()
