"""The port's render slice against the JAX package's, end to end on CPU.

Both renderers get the same FlatScene (the JAX flatten, carried across
with flat_from_numpy) and render the same sample indices with
render_step_n: the small colonnade through the packet tracer (JAX: the
Pallas kernel in interpret mode; port: the kernel's plain version) and
the helmet (HDR environment, clearcoat, anisotropic metal) through the
packet tracer, and Cornell through the brute tracer (also with the
`simple` kernel and the pcg4d sampler, and with the Z-sampler). Bars: per pixel rtol=2e-3, atol=2e-3
(tests/test_pallas_trace.py:271) on >= 99.5% of pixels; the image means
agree to 1e-3 relative. A pixel may only leave the per-pixel bar where a
borderline hit flip split its path; the test prints how many did.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import (make_colonnade_scene,
                                     make_cornell_scene, make_helmet_scene)
from platinum_tpu.io.exr import read_exr
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.renderer import Renderer as JRenderer
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app.scenes import (
    make_cornell_scene as make_port_cornell)
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3

CONFIGS = {
    "colonnade_small_packet": (
        lambda: make_colonnade_scene(sphere_res=(12, 16)),
        dict(width=32, height=32, spp=2, max_bounces=8, kernel="mis",
             sampler="halton", tracer="packet", instancing="off")),
    # two-level instancing: the plain K3 version against K3 in interpret mode
    "colonnade_small_packet_instanced": (
        lambda: make_colonnade_scene(sphere_res=(12, 16)),
        dict(width=32, height=32, spp=2, max_bounces=8, kernel="mis",
             sampler="halton", tracer="packet", instancing="on")),
    "cornell_brute": (
        make_cornell_scene,
        dict(width=32, height=32, spp=2, max_bounces=8, kernel="mis",
             sampler="halton", tracer="brute")),
    # HDR environment (alias-sampled, MIS), clearcoat and anisotropic metal
    "helmet_env_packet": (
        make_helmet_scene,
        dict(width=16, height=16, spp=2, max_bounces=4, kernel="mis",
             sampler="halton", tracer="packet", instancing="off")),
    "cornell_simple_pcg4d": (
        make_cornell_scene,
        dict(width=32, height=32, spp=2, max_bounces=8, kernel="simple",
             sampler="pcg4d", tracer="brute")),
    # the Z-sampler: make_stream takes the image size and the spp budget
    "cornell_z": (
        make_cornell_scene,
        dict(width=32, height=32, spp=2, max_bounces=8, kernel="mis",
             sampler="z", tracer="brute")),
}


def _hold(img, ref, name):
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img.mean() / ref.mean() - 1.0)
    print(f"{name}: {int((~close).sum())} of {close.size} pixels outside "
          f"rtol={PIX_RTOL} atol={PIX_ATOL}; mean {img.mean():.6f} vs "
          f"{ref.mean():.6f} (rel {rel:.2e})")
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert rel <= MEAN_RTOL


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_step_n_matches_jax(name):
    make, kw = CONFIGS[name]
    scene, cam = make()
    jset = JSettings(**kw)
    jflat = jflatten(scene, cam, jset)
    n = jset.num_pixels
    ref = np.asarray(jintegrator.render_step_n(
        jflat, jset, jnp.zeros((n, 3)), jnp.int32(0), kw["spp"],
        features=janalyze(jflat)))

    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    feats = analyze_features(flat)
    img = integrator.render_step_n(flat, RenderSettings(**kw),
                                   torch.zeros((n, 3)), 0, kw["spp"],
                                   features=feats).numpy()
    _hold(img, ref, name)
    if name.startswith("colonnade"):
        # the camera must see the lit hall, or the comparison proves little
        assert "area_lights" in feats and "metallic" in feats
        assert ref.mean() > 0.5 and ref.max() > 10.0
    if name.startswith("helmet"):
        assert {"env", "clearcoat", "aniso", "metallic"} <= feats


def test_render_matches_jax():
    """integrator.render: spp in calls of spp_per_call, (H, W, 3) out."""
    scene, cam = make_cornell_scene()
    kw = dict(width=16, height=12, spp=3, max_bounces=5, kernel="mis",
              sampler="halton")
    jflat = jflatten(scene, cam, JSettings(**kw))
    ref = np.asarray(jintegrator.render(jflat, JSettings(**kw),
                                        features=janalyze(jflat),
                                        spp_per_call=2))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    img = integrator.render(flat, RenderSettings(**kw),
                            features=analyze_features(flat),
                            spp_per_call=2).numpy()
    assert img.shape == ref.shape == (12, 16, 3)
    _hold(img.reshape(-1, 3), ref.reshape(-1, 3), "render cornell")


def test_renderer_api_matches_jax_renderer(tmp_path):
    """Renderer(scene).start_render / render / status / readback /
    export_exr against the JAX Renderer's progressive 1-spp steps."""
    scene, cam = make_cornell_scene()
    kw = dict(width=24, height=24, spp=3, max_bounces=6, kernel="mis",
              sampler="halton")
    jr = JRenderer(scene)
    jr.start_render(cam, JSettings(**kw))
    jr.render_all()
    ref = jr.readback()

    scene, cam = make_port_cornell()
    r = Renderer(scene, device="cpu")
    assert r.status == RenderStatus.READY
    r.start_render(cam, RenderSettings(**kw))
    assert r.status & RenderStatus.BUSY
    while not r.status & RenderStatus.DONE:
        r.render()
    img = r.readback()
    assert img.shape == (24, 24, 3)
    _hold(img, ref, "renderer cornell")
    path = str(tmp_path / "cornell.exr")
    r.export_exr(path)
    np.testing.assert_array_equal(read_exr(path)[..., :3], img)


@pytest.mark.parametrize("override", [dict(tracer="bvh")])
def test_unported_options_raise(override):
    scene, cam = make_cornell_scene()
    settings = RenderSettings(width=8, height=8, spp=1, max_bounces=2,
                              **override)
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflatten(
        scene, cam, JSettings(width=8, height=8), accel_min_tris=1)), "cpu")
    assert flat.wbvh_nodes is not None
    with pytest.raises(NotImplementedError, match=r"item 12\b"):
        integrator.render_step(flat, settings, torch.zeros((64, 3)), 0,
                               features=analyze_features(flat))
    # a scene without a wide BVH reaches make_tracers' own refusal
    brute = flat_from_numpy(jax.tree.map(np.asarray, jflatten(
        scene, cam, JSettings(width=8, height=8))), "cpu")
    assert brute.wbvh_nodes is None
    with pytest.raises(NotImplementedError, match=r"item 12\b"):
        integrator.make_tracers(brute, settings)
