"""The port's entry points against the JAX package's API.

`flatten_scene`, `render_sample` and `Renderer.__init__` take the JAX
package's positional parameters in its order; what only the port has
(`device`) comes after them, keyword-only. `build_accel=False` builds no
BVH, as in JAX. The Renderer builds its (trace_closest, trace_any) pair
once per `start_render` (for the auto plan's probe and every step) and
once per `update_instance_transform`, not once per sample. The
Renderer takes the post stack's options and exports a PNG through them.
`render_sample(pixel_ids=)` renders those pixels' rows (ported with the
multi-device path); `tracer="bvh"` (ported with ROADMAP item 12) renders
the JAX package's sample.
"""

import inspect

import numpy as np
import pytest
import torch

from instanced_scenes import instanced_scene
from platinum_tpu.app import scenes as jscenes
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.integrator import render_sample as jrender_sample
from platinum_tpu.render.renderer import Renderer as JRenderer
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.post.options import (ExposureOptions,
                                             PostProcessOptions,
                                             TonemapOptions)
from platinum_tpu_torch.render import autoplan, integrator
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)

PAIRS = {"flatten_scene": (flatten_scene, jflatten),
         "render_sample": (integrator.render_sample, jrender_sample),
         "Renderer.__init__": (Renderer.__init__, JRenderer.__init__)}


def _split(fn):
    """(the parameters that can be passed by position, the rest)."""
    params = list(inspect.signature(fn).parameters.values())
    n = next((i for i, p in enumerate(params)
              if p.kind not in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)),
             len(params))
    return params[:n], params[n:]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_positional_parameters_are_the_jax_packages(name):
    port, jax_fn = PAIRS[name]
    mine, extra = _split(port)
    ref, _ = _split(jax_fn)
    assert [p.name for p in mine] == [p.name for p in ref]
    for p, r in zip(mine, ref):
        if r.default is None or isinstance(r.default, (bool, int, str)):
            assert p.default == r.default, p.name
    # what only the port has is keyword-only
    assert all(p.kind == p.KEYWORD_ONLY for p in extra)
    if name != "render_sample":
        assert [p.name for p in extra] == ["device"]


def test_build_accel_false_builds_no_bvh_as_jax():
    jflat = jflatten(*jscenes.make_cornell_scene(), JSettings(
        width=16, height=16), build_accel=False)
    flat = flatten_scene(*scenes.make_cornell_scene(), RenderSettings(
        width=16, height=16), build_accel=False, device="cpu")
    for field in ("bvh_nodes", "wbvh_nodes", "wbvh_tris", "wbvh_meta"):
        assert getattr(jflat, field) is None
        assert getattr(flat, field) is None, field
    assert flat.geometry.indices.shape == tuple(jflat.geometry.indices.shape)
    with_bvh = flatten_scene(*scenes.make_cornell_scene(), RenderSettings(
        width=16, height=16), accel_min_tris=1, device="cpu")
    assert with_bvh.wbvh_nodes is not None


def test_renderer_takes_post_options_and_exports_png(tmp_path):
    """Renderer(scene, post_options) renders and exports through them."""
    import numpy as np
    from PIL import Image

    scene, cam = scenes.make_cornell_scene()
    post = PostProcessOptions(exposure=ExposureOptions(exposure=1.0),
                              tonemap=TonemapOptions(tonemapper="flim"))
    r = Renderer(scene, post, device="cpu")
    assert r.post_options is post
    r.start_render(cam, RenderSettings(width=12, height=10, spp=2,
                                       max_bounces=2))
    r.render_all()
    path = str(tmp_path / "cornell.png")
    r.export_png(path)
    img = np.asarray(Image.open(path))
    assert img.shape == (10, 12, 3) and img.mean() > 0
    default = Renderer(scene, device="cpu").post_options
    assert default == PostProcessOptions()
    assert not np.array_equal(r.output_image(),
                              r.output_image(PostProcessOptions()))


def test_unported_parameters_raise():
    """`pixel_ids`, which raised until the multi-device path was ported,
    renders those pixels' rows; `tracer="bvh"`, which raised until item
    12 was ported, renders the JAX package's sample."""
    scene, cam = scenes.make_cornell_scene()
    s = RenderSettings(width=4, height=4, max_bounces=2)
    flat = flatten_scene(scene, cam, s, device="cpu")
    ids = torch.tensor([13, 2, 7, 0])
    rows = integrator.render_sample(flat, s, 0, ids)
    assert rows.shape == (4, 3)
    assert torch.equal(rows, integrator.render_sample(flat, s, 0)[ids])
    # tracer="bvh", which raised until its module was ported (item 12),
    # renders JAX's sample through the same positional parameters
    kw = dict(width=4, height=4, max_bounces=2, tracer="bvh")
    jflat = jflatten(*jscenes.make_cornell_scene(), JSettings(**kw), True, 1)
    ref = np.asarray(jrender_sample(jflat, JSettings(**kw), 0))
    flat = flatten_scene(scene, cam, RenderSettings(**kw), True, 1,
                         device="cpu")
    assert flat.bvh_skip is not None
    img = integrator.render_sample(flat, RenderSettings(**kw), 0).numpy()
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-3)


@pytest.fixture
def counted(monkeypatch):
    """make_tracers, counting its calls."""
    calls = []
    real = integrator.make_tracers

    def make_tracers(flat, settings):
        calls.append(settings)
        return real(flat, settings)

    monkeypatch.setattr(integrator, "make_tracers", make_tracers)
    return calls


def test_renderer_builds_the_tracers_once_per_start_and_edit(counted):
    scene, cam = instanced_scene("platinum_tpu_torch", n_inst=12,
                                 emissive=False, seed=3)
    r = Renderer(scene, device="cpu")
    r.start_render(cam, RenderSettings(width=8, height=8, spp=5,
                                       max_bounces=2, instancing="on",
                                       tracer="packet"))
    for _ in range(4):
        r.render()
    assert len(counted) == 1 and r._accumulated == 4
    node_id = r._host_accel["instances"][5].node_id
    r.update_instance_transform(node_id, Transform(
        translation=[2.0, 1.0, -1.5], rotation=[0.3, 0.2, 0.1],
        scale=[1.4] * 3))
    r.render()
    assert len(counted) == 2 and r._accumulated == 1


def test_auto_plan_probe_takes_the_given_tracers(counted):
    """The probe of compact_plan="auto" runs on the pair it is given."""
    scene, cam = instanced_scene("platinum_tpu_torch", n_inst=6,
                                 emissive=False, seed=1)
    settings = RenderSettings(width=96, height=96, max_bounces=4,
                              compact=True, compact_plan="auto",
                              instancing="on", tracer="packet")
    flat = flatten_scene(scene, cam, settings, device="cpu")
    pair = integrator.make_tracers(flat, settings)
    resolved = autoplan.resolve_auto_plan(flat, settings, tracers=pair)
    assert isinstance(resolved.compact_plan, tuple)
    assert len(counted) == 1
