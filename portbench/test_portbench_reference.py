"""The plain reference against the program on the CPU: lane for lane on a
small colonnade (compaction off at this size), the light order taken from
the program and checked, and the display image against the post stack."""

import numpy as np
import pytest
import torch

from portbench import compare, harness, scenes
from portbench.reference import pathtracer, post


@pytest.fixture(scope="module")
def small():
    from platinum_tpu_torch.render.renderer import Renderer
    from platinum_tpu_torch.render.types import RenderSettings

    arrays = scenes.colonnade(columns=4, rows=2, sphere_res=(12, 16))
    scene, cam = harness.port_scene(arrays)
    r = Renderer(scene, device="cpu")
    r.start_render(cam, RenderSettings(
        width=40, height=24, spp=64, max_bounces=8, kernel="mis",
        sampler="halton", tracer="packet", compact=True,
        compact_plan="auto", instancing="off"))
    return arrays, r


def test_lanes_agree_with_the_program(small):
    from platinum_tpu_torch.render import integrator

    arrays, r = small
    samples = [0, 7, 1000003]
    prog = np.stack([integrator.render_sample(
        r.flat, r.settings, s, tracers=r._tracers,
        features=r._features).numpy() for s in samples], 1)
    scene = pathtracer.compile_scene(arrays, 40, 24)
    order, gap = pathtracer.match_lights(
        scene, r.flat.lights.packed[:, :9].numpy())
    assert gap <= 1e-5
    rows, total = pathtracer.light_table(scene, order)
    np.testing.assert_allclose(rows, r.flat.lights.packed.numpy(), rtol=1e-6,
                               atol=1e-6)
    t = pathtracer.device_tables(scene, rows, total, "cpu", torch.float32)
    ref = pathtracer.render_pixels(t, np.arange(40 * 24), samples, 8).numpy()
    g = compare.gaps(prog.reshape(-1, 3), ref.reshape(-1, 3))
    assert np.median(g) < 1e-6
    assert (g > 1e-3).mean() < 0.01
    assert prog.mean() > 0.01


def test_light_rows_must_be_the_scenes_emitters(small):
    arrays, r = small
    scene = pathtracer.compile_scene(arrays, 40, 24)
    rows = r.flat.lights.packed[:, :9].numpy().copy()
    rows[3] = rows[4]                       # one emitter twice, one missing
    with pytest.raises(ValueError):
        pathtracer.match_lights(scene, rows)


def test_display_agrees_with_the_post_stack():
    from platinum_tpu_torch.post.options import PostProcessOptions
    from platinum_tpu_torch.post.pipeline import postprocess_image

    g = torch.Generator().manual_seed(3)
    img = torch.rand((8, 16, 3), generator=g) ** 3 * 20.0
    prog = postprocess_image(img, PostProcessOptions()).reshape(-1, 3)
    ref = post.display(img.reshape(-1, 3))
    assert float((prog - ref).abs().max()) < 1e-5
