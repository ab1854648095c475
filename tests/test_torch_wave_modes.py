"""The port's wave-shaping modes against the JAX integrator's, on the CPU.

`fuse_shadow`, `chunk_shade` and `spp_batch` on Cornell at the sizes of
tests/test_integrator.py:270-337, with its bars: the fused path equals
the unfused one to 1e-6, chunked shading equals dense to 2e-4 (and a
chunk that does not divide the wave falls back to dense bit for bit),
and a sample batch is bit-identical to sequential samples. Each mode is
also held to the JAX integrator in the same mode on the same FlatScene,
per pixel to the bars of tests/test_torch_slice.py. The slice as a whole:
render_step_n with the ray-stream pair as `tracers=` against the JAX
integrator with the JAX ray-stream pair (its Pallas kernel in interpret
mode).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_colonnade_scene, make_cornell_scene
from platinum_tpu.ops.raystream import make_stream_tracer as jstream
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app.scenes import (
    make_cornell_scene as make_port_cornell)
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.ops.raystream import make_stream_tracer
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3     # tests/test_torch_slice.py
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3


def _cornell(kw, **flatten_kw):
    """(JAX flat, port flat) of Cornell for the settings `kw`."""
    scene, cam = make_cornell_scene()
    jflat = jflatten(scene, cam, JSettings(**kw), **flatten_kw)
    return jflat, flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")


def _port_render(flat, settings):
    return integrator.render(flat, settings,
                             features=analyze_features(flat)).numpy()


def _hold_to_jax(img, ref, name):
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img.mean() / ref.mean() - 1.0)
    print(f"{name}: {int((~close).sum())} of {close.size} pixels outside "
          f"rtol={PIX_RTOL} atol={PIX_ATOL}; mean rel {rel:.2e}")
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert rel <= MEAN_RTOL


FUSE = dict(width=24, height=24, spp=8, max_bounces=5, kernel="mis",
            sampler="pcg4d")


def test_fuse_shadow_matches_unfused_and_jax():
    """The fused path traces the same rays as the unfused one: equal to
    1e-6 (tests/test_integrator.py:284), and to the JAX integrator's fused
    render per pixel."""
    jflat, flat = _cornell(FUSE)
    unfused = _port_render(flat, RenderSettings(**FUSE))
    fused = _port_render(flat, RenderSettings(fuse_shadow=True, **FUSE))
    np.testing.assert_allclose(fused, unfused, rtol=1e-6, atol=1e-6)
    ref = np.asarray(jintegrator.render(
        jflat, JSettings(fuse_shadow=True, **FUSE), features=janalyze(jflat)))
    _hold_to_jax(fused, ref, "fuse_shadow")


def test_fuse_shadow_launches_one_closest_wave_per_bounce():
    """With fuse_shadow the bounce loop calls trace_closest alone, on a
    wave twice as wide; trace_any runs only from resolve_pending."""
    _, flat = _cornell(FUSE)
    settings = RenderSettings(fuse_shadow=True, **FUSE)
    feats = analyze_features(flat)
    closest, any_hit = integrator.make_tracers(flat, settings)
    calls = []

    def tc(o, d, tmin, tmax, active=None):
        calls.append(("closest", o.shape[0]))
        return closest(o, d, tmin, tmax, active=active)

    def ta(o, d, tmin, tmax, active=None):
        calls.append(("any", o.shape[0]))
        return any_hit(o, d, tmin, tmax, active=active)

    integrator.render_sample(flat, settings, 0, tracers=(tc, ta),
                             features=feats)
    n = settings.num_pixels
    assert calls[-1] == ("any", n)            # resolve_pending, at the end
    assert all(c == ("closest", 2 * n) for c in calls[:-1])
    assert 2 <= len(calls) - 1 <= settings.max_bounces


def test_fuse_shadow_with_compaction_settles_pending_shadows():
    """tests/test_integrator.py:287-291, and against the unfused compacted
    render: the same lanes survive (the selection keys do not depend on
    the mode), so the images agree to 1e-6."""
    kw = dict(FUSE, compact=True, width=96, height=96, spp=2)
    _, flat = _cornell(kw)
    fused = _port_render(flat, RenderSettings(fuse_shadow=True, **kw))
    unfused = _port_render(flat, RenderSettings(**kw))
    assert np.isfinite(fused).all() and fused.mean() > 0.1
    np.testing.assert_allclose(fused, unfused, rtol=1e-6, atol=1e-6)


CHUNK = dict(width=32, height=32, spp=2, max_bounces=5, kernel="mis",
             sampler="pcg4d")


@pytest.fixture(scope="module")
def chunk_scene():
    jflat, flat = _cornell(CHUNK)
    return jflat, flat, _port_render(flat, RenderSettings(**CHUNK))


@pytest.mark.parametrize("chunk", [128, 256])
def test_chunk_shade_matches_dense_and_jax(chunk_scene, chunk):
    """Chunked shading draws what dense shading draws: equal to 2e-4
    (tests/test_integrator.py:309), and to the JAX integrator's chunked
    render per pixel."""
    jflat, flat, dense = chunk_scene
    img = _port_render(flat, RenderSettings(chunk_shade=chunk, **CHUNK))
    np.testing.assert_allclose(img, dense, rtol=2e-4, atol=2e-4)
    ref = np.asarray(jintegrator.render(
        jflat, JSettings(chunk_shade=chunk, **CHUNK),
        features=janalyze(jflat)))
    _hold_to_jax(img, ref, f"chunk_shade={chunk}")


def test_chunk_shade_that_does_not_divide_falls_back_to_dense(chunk_scene):
    _, flat, dense = chunk_scene
    img = _port_render(flat, RenderSettings(chunk_shade=300, **CHUNK))
    np.testing.assert_array_equal(img, dense)


def test_chunk_shade_with_halton_keeps_the_shared_dimension(chunk_scene):
    """The Halton stream's dimension counter is one Python int for all
    lanes: every chunk advances it by the same amount, and the merged
    stream carries it once."""
    _, flat, _ = chunk_scene
    kw = dict(CHUNK, sampler="halton")
    dense = _port_render(flat, RenderSettings(**kw))
    img = _port_render(flat, RenderSettings(chunk_shade=128, **kw))
    np.testing.assert_allclose(img, dense, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sampler", ["pcg4d", "halton"])
def test_spp_batch_is_bit_identical_to_sequential_and_matches_jax(sampler):
    """tests/test_integrator.py:316-337 on the port: every lane of a
    batch draws and traces what its sequential sample does, so a batch's
    radiance is bit for bit the sum of its samples, and render_step_n
    over two batches is bit for bit the sequential samples summed batch
    by batch. Against four samples summed one after the other only the
    order of the last fp32 additions differs (held to 1e-6). The batch is
    also held to the JAX integrator's per pixel."""
    kw = dict(width=32, height=32, spp=4, max_bounces=4, kernel="mis",
              sampler=sampler, tracer="packet", compact=True)
    jflat, flat = _cornell(kw, accel_min_tris=1)
    feats = analyze_features(flat)
    batched = RenderSettings(spp_batch=2, **kw)
    one = [integrator.render_sample(flat, RenderSettings(**kw), i,
                                    features=feats) for i in range(4)]
    for first in (0, 2):
        pair = integrator.render_sample(flat, batched, first, features=feats)
        assert torch.equal(pair, one[first] + one[first + 1])
    b = integrator.render_step_n(flat, batched, torch.zeros((1024, 3)), 0, 4,
                                 features=feats)
    assert torch.equal(b, ((one[0] + one[1]) + (one[2] + one[3])) / 4.0)
    a = integrator.render_step_n(flat, RenderSettings(**kw),
                                 torch.zeros((1024, 3)), 0, 4, features=feats)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)
    ref = np.asarray(jintegrator.render_step_n(
        jflat, JSettings(spp_batch=2, **kw), jnp.zeros((1024, 3)),
        jnp.int32(0), 4, features=janalyze(jflat)))
    _hold_to_jax(b.numpy(), ref, f"spp_batch=2 {sampler}")


def test_spp_batch_without_compaction_sums_per_pixel():
    """One plan segment: the batch's lanes scatter into their pixels."""
    kw = dict(width=16, height=16, spp=2, max_bounces=3, kernel="mis",
              sampler="pcg4d")
    _, flat = _cornell(kw)
    feats = analyze_features(flat)
    both = integrator.render_sample(flat, RenderSettings(spp_batch=2, **kw),
                                    0, features=feats)
    one = [integrator.render_sample(flat, RenderSettings(**kw), i,
                                    features=feats) for i in (0, 1)]
    assert both.shape == (256, 3)
    assert torch.equal(both, one[0] + one[1])


def test_spp_batch_refusals():
    """render_step is a 1-spp step; render_step_n wants whole batches;
    start_render refuses an spp the batch does not divide (the JAX
    Renderer finds out at its last batch)."""
    kw = dict(width=8, height=8, max_bounces=2, spp_batch=2)
    _, flat = _cornell(dict(width=8, height=8))
    feats = analyze_features(flat)
    with pytest.raises(ValueError, match="1-spp step"):
        integrator.render_step(flat, RenderSettings(spp=2, **kw),
                               torch.zeros((64, 3)), 0, features=feats)
    with pytest.raises(ValueError, match="multiple of spp_batch"):
        integrator.render_step_n(flat, RenderSettings(spp=4, **kw),
                                 torch.zeros((64, 3)), 0, 3, features=feats)
    scene, cam = make_port_cornell()
    renderer = Renderer(scene, device="cpu")
    with pytest.raises(ValueError, match="multiple of spp_batch"):
        renderer.start_render(cam, RenderSettings(spp=3, **kw))


def test_renderer_steps_whole_batches():
    scene, cam = make_port_cornell()
    kw = dict(width=16, height=16, spp=4, max_bounces=3, sampler="pcg4d")
    imgs = {}
    for batch in (1, 2):
        r = Renderer(scene, device="cpu")
        r.start_render(cam, RenderSettings(spp_batch=batch, **kw))
        steps = 0
        while not r.status & 4:     # RenderStatus.DONE
            r.render()
            steps += 1
        assert steps == 4 // batch
        imgs[batch] = r.readback()
    np.testing.assert_allclose(imgs[2], imgs[1], rtol=1e-6, atol=1e-7)


def test_slice_with_the_ray_stream_pair_matches_jax():
    """The slice as a whole: render_step_n with the port's ray-stream pair
    as `tracers=` against the JAX integrator with the JAX pair (render_
    sample takes `tracers=` there; the running mean is formed here), on
    the small colonnade, per pixel to the bars of test_torch_slice.py."""
    scene, cam = make_colonnade_scene(sphere_res=(12, 16))
    kw = dict(width=24, height=24, spp=2, max_bounces=4, kernel="mis",
              sampler="halton", tracer="packet", instancing="off")
    jset = JSettings(**kw)
    jflat = jflatten(scene, cam, jset)
    jpair = jstream(jflat.wbvh_nodes, jflat.wbvh_tris, jflat.wbvh_meta,
                    jflat.wbvh_slot)
    jfeats = janalyze(jflat)
    sample = jax.jit(lambda i: jintegrator.render_sample(
        jflat, jset, i, tracers=jpair, features=jfeats))
    ref = sum(np.asarray(sample(jnp.int32(i))) for i in range(2)) / 2.0

    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    pair = make_stream_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                              flat.wbvh_meta, flat.wbvh_slot)
    img = integrator.render_step_n(flat, RenderSettings(**kw),
                                   torch.zeros((jset.num_pixels, 3)), 0, 2,
                                   features=analyze_features(flat),
                                   tracers=pair).numpy()
    _hold_to_jax(img, ref, "ray-stream slice")
    assert ref.mean() > 0.3
