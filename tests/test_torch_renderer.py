"""The port's Renderer on the CPU against the JAX Renderer, step by step:

- the spheres scene (normal-mapped ground, textured through the atlas)
  at 32x32, 2 bounces, 4 spp;
- Cornell with FLAG_GMON and 4 GMoN buckets at 8 spp;
- Cornell through the preview ladder (preview_scale=2);
- Cornell with a fully cut-out (alpha-tested) material.

After every render() call: `completed_spp`, `render_progress` and `status`
equal, and `readback()` within RMSE 1e-3 of the JAX image (the bar of
tests/test_golden.py:37); at the end `output_image()` too. A checkpoint the
JAX Renderer saves loads into the port's Renderer and reads back bitwise
the JAX image; `export_png` writes the post stack's pixels with the output
space's ICC profile; the telemetry events are the JAX Renderer's.
"""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from platinum_tpu.app import scenes as jscenes
from platinum_tpu.render.renderer import Renderer as JRenderer
from platinum_tpu.render.types import FLAG_GMON as JFLAG_GMON
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.io import icc
from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
from platinum_tpu_torch.render.types import FLAG_GMON, RenderSettings
from platinum_tpu_torch.utils import telemetry

torch.set_num_threads(1)

RMSE = 1e-3
RUNS = {
    "spheres": ("make_spheres_scene", {},
                dict(width=32, height=32, spp=4, max_bounces=2), 0),
    "cornell_gmon": ("make_cornell_scene", {},
                     dict(width=32, height=32, spp=8, max_bounces=3,
                          flags=1 | FLAG_GMON, gmon_buckets=4), 0),
    "cornell_preview": ("make_cornell_scene", {},
                        dict(width=30, height=30, spp=6, max_bounces=3), 2),
}
assert FLAG_GMON == JFLAG_GMON


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _drive(renderer, cam, settings, preview_scale):
    renderer.start_render(cam, settings, preview_scale=preview_scale,
                          preview_spp=2)
    steps = [(renderer.completed_spp, renderer.render_progress,
              int(renderer.status), None)]
    while not renderer.status & RenderStatus.DONE:
        renderer.render()
        steps.append((renderer.completed_spp, renderer.render_progress,
                      int(renderer.status), renderer.readback()))
    return steps


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    make, args, kw, pv = RUNS[request.param]
    jscene, jcam = getattr(jscenes, make)(**args)
    jr = JRenderer(jscene)
    jsteps = _drive(jr, jcam, JSettings(**kw), pv)
    scene, cam = getattr(scenes, make)(**args)
    r = Renderer(scene, device="cpu")
    steps = _drive(r, cam, RenderSettings(**kw), pv)
    return request.param, jr, jsteps, r, steps


def test_progress_is_the_jax_renderers_step_by_step(run):
    _, jr, jsteps, r, steps = run
    assert len(steps) == len(jsteps)
    for (c, p, s, _), (jc, jp, js, _) in zip(steps, jsteps):
        assert (c, p, s) == (jc, jp, js)
    assert r.completed_spp == r.settings.spp
    assert r.render_time > 0.0


def test_readback_and_output_image_match_jax(run):
    name, jr, jsteps, r, steps = run
    for (*_, img), (*_, jimg) in zip(steps[1:], jsteps[1:]):
        assert img.shape == jimg.shape
        assert _rmse(img, jimg) <= RMSE
    assert float(steps[-1][3].mean()) > 0.0
    assert _rmse(r.output_image(), jr.output_image()) <= RMSE
    if name == "cornell_preview":
        # the first readbacks are the upscaled preview frames
        assert r._pv["done"] == 2 and steps[1][3].shape == (30, 30, 3)
        assert np.array_equal(steps[1][3][0::2, 0::2], steps[1][3][1::2, 1::2])
    if name == "spheres":
        assert r.flat.atlas is not None
        assert "texslot5" in r._features          # the normal map


def test_jax_checkpoint_loads_bitwise(run, tmp_path):
    _, jr, _, r, _ = run
    path = str(tmp_path / "ckpt.npz")
    jr.save_checkpoint(path)
    r.load_checkpoint(path)
    assert r.completed_spp == jr.completed_spp
    assert np.array_equal(r.readback(), jr.readback())
    r.save_checkpoint(str(tmp_path / "port.npz"))
    a, b = np.load(path), np.load(str(tmp_path / "port.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k


def test_export_png_writes_the_output_image(run, tmp_path):
    _, _, _, r, _ = run
    path = str(tmp_path / "out.png")
    r.export_png(path)
    im = Image.open(path)
    want = (np.clip(r.output_image(), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert im.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(im), want)
    assert im.info["icc_profile"] == icc.profile_for(r.settings.output_space)


def test_telemetry_events_are_the_jax_renderers(monkeypatch):
    from platinum_tpu.utils import telemetry as jtelemetry

    logs = {}
    for mod in (telemetry, jtelemetry):
        logs[mod] = io.StringIO()
        monkeypatch.setattr(mod, "_CHECKED", True)
        monkeypatch.setattr(mod, "_DEST", logs[mod])
    kw = dict(width=8, height=8, spp=2, max_bounces=2)
    jscene, jcam = jscenes.make_cornell_scene()
    _drive(JRenderer(jscene), jcam, JSettings(**kw), 2)
    scene, cam = scenes.make_cornell_scene()
    _drive(Renderer(scene, device="cpu"), cam, RenderSettings(**kw), 2)

    def events(buf):
        return [(e["event"], e.get("frame"), e.get("spp_done"))
                for e in map(json.loads, buf.getvalue().splitlines())]

    got = events(logs[telemetry])
    assert got == events(logs[jtelemetry])
    assert [e[0] for e in got] == ["preview_frame", "preview_frame",
                                   "render_step", "render_step",
                                   "render_done"]


def test_gmon_with_spp_batch_raises_as_jax():
    scene, cam = scenes.make_cornell_scene()
    with pytest.raises(ValueError, match="GMoN"):
        Renderer(scene, device="cpu").start_render(cam, RenderSettings(
            width=4, height=4, spp=4, flags=FLAG_GMON, gmon_buckets=2,
            spp_batch=2))


def test_alpha_cutout_still_raises_by_name():
    """(The name is from when the port refused cutouts.) A Cornell box
    whose first instance takes a fully cut-out textured material renders
    through the port's Renderer as through the JAX Renderer, to the
    Renderer's RMSE bar."""
    from platinum_tpu.core.material import Material as JMaterial
    from platinum_tpu.core.material import TextureSlot as JSlot
    from platinum_tpu.core.texture import Texture as JTexture
    from platinum_tpu.core.texture import TextureFormat as JFormat
    from platinum_tpu_torch.core.material import Material, TextureSlot
    from platinum_tpu_torch.core.texture import Texture, TextureFormat

    rgba = np.full((4, 4, 4), 200, np.uint8)
    rgba[..., 3] = 0                                  # fully cut out
    kw = dict(width=8, height=8, spp=2, max_bounces=3)
    out = []
    for sc, Mat, Slot, Tex, Fmt, R, S in (
            (jscenes, JMaterial, JSlot, JTexture, JFormat, JRenderer,
             JSettings),
            (scenes, Material, TextureSlot, Texture, TextureFormat,
             Renderer, RenderSettings)):
        scene, cam = sc.make_cornell_scene()
        tid = scene.add_asset(Tex(data=rgba, format=Fmt.SRGB_RGBA,
                                  has_alpha=True))
        mid = scene.add_asset(Mat(name="leaf",
                                  textures={Slot.BASE_COLOR: tid}))
        scene.set_material(scene.get_instances()[0].node_id, 0, mid)
        r = R(scene) if R is JRenderer else R(scene, device="cpu")
        r.start_render(cam, S(**kw))
        r.render_all()
        out.append(r)
    jr, r = out
    assert r.flat.atlas is not None and "alpha" in r._features
    img, ref = r.readback(), np.asarray(jr.readback())
    assert np.isfinite(img).all() and img.mean() > 0
    assert float(np.sqrt(np.mean((img - ref) ** 2))) <= RMSE
