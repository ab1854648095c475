"""The port's studio viewport (render/studio.py) and `preview` command
against the JAX package's, on the CPU.

- StudioRenderer.render at 64x48 with a selection, on the small colonnade
  (the packet tracer: JAX's kernel in interpret mode, the port's plain
  version) and on Cornell (the brute tracer). Object ids bit for bit; on
  Cornell a ray whose hit the two brute tracers decide differently (their
  fp32 sums are ordered differently: tests/test_torch_trace.py holds them
  to the same certificate) must be borderline in float64, and only there
  may ids, or the triangle within a node, differ. Colours within
  COLOR_ATOL everywhere else, and wherever an outline's stencil (a
  pixel and its four neighbours) saw the same ids.
- StudioCamera's orbit / pan / zoom / move_to / attach and the camera
  gizmos bitwise JAX's; picking returns JAX's ids.
- `preview` prints JAX's pick and writes its image; `preview
  --interactive` driven through stdin as tests/test_studio.py drives
  JAX's session, in one subprocess; the scene it saves loads in JAX.
- StudioRenderer defaults to the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from platinum_tpu.app import cli as jcli
from platinum_tpu.app import scenes as jscenes
from platinum_tpu.render.studio import StudioCamera as JCamera
from platinum_tpu.render.studio import StudioRenderer as JStudio
from platinum_tpu.render.studio import camera_gizmo_segments as jgizmos
from platinum_tpu_torch.app import cli
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.render.studio import (StudioCamera, StudioRenderer,
                                              camera_gizmo_segments)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOR_ATOL = 1e-5
W, H = 64, 48
SMALL = dict(columns=4, rows=2, sphere_res=(10, 14))
SCENES = {"colonnade_small": ("make_colonnade_scene", SMALL),
          "cornell": ("make_cornell_scene", {})}


def _studios(name):
    make, kw = SCENES[name]
    out = []
    for sc, S, extra in ((jscenes, JStudio, {}),
                         (scenes, StudioRenderer, {"device": "cpu"})):
        scene, cam = getattr(sc, make)(**kw)
        studio = S(scene, width=W, height=H, **extra)
        m = scene.world_transform(cam)
        studio.camera_to(m[:3, 3], m[:3, 3] - m[:3, 2] * 10.0)
        out.append((scene, studio))
    return out


def _borderline(studio, rays):
    """Every ray in `rays` grazes a triangle edge (or the t range) in
    float64, as tests/test_pallas_trace.py certifies a disagreement."""
    from test_pallas_trace import _assert_borderline

    from platinum_tpu_torch.models.camera_rays import spawn_camera_rays

    flat = studio._flat
    pix = torch.as_tensor(rays)
    center = torch.full((len(rays), 2), 0.5)
    o, d = spawn_camera_rays(flat.camera, pix % W, pix // W, center, center)
    p = flat.geometry.positions.numpy()
    idx = flat.geometry.indices.numpy()
    v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    for k in range(len(rays)):
        _assert_borderline(k, o.numpy(), d.numpy(), v0, v1, v2, 1e-3,
                           np.inf, "studio id")


def _stencil(mask):
    """The pixels whose outline stencil (themselves and their four
    neighbours, wrapping as jnp.roll does) touches `mask`."""
    out = mask.copy()
    for s in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        out |= np.roll(mask, s, axis=(0, 1))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_studio_frame_matches_jax(name):
    (jscene, jstudio), (scene, studio) = _studios(name)
    plain = studio.render()
    # select the node that covers the most pixels
    jstudio.render()
    ids0 = np.asarray(jstudio._ids)
    vals, counts = np.unique(ids0[ids0 >= 0], return_counts=True)
    sel = int(vals[np.argmax(counts)])
    ref = jstudio.render(selected_node=sel)
    img = studio.render(selected_node=sel)
    jids, ids = np.asarray(jstudio._ids), studio._ids.numpy()
    assert img.shape == ref.shape == (H, W, 3) and ids.dtype == np.int32
    differ = ids != jids
    off = np.abs(img - ref).max(-1) > COLOR_ATOL
    print(f"{name}: {int(differ.sum())} ids differ, {int(off.sum())} "
          f"colours off by more than {COLOR_ATOL}")
    if name == "cornell":
        # the brute tracer: a ray the two tracers decide differently (its
        # id, or the triangle and so the material within the one node)
        # must be borderline; the outline follows the ids' stencil
        assert studio._flat.wbvh_nodes is None
        _borderline(studio, np.flatnonzero((differ | (off & ~_stencil(
            differ))).ravel()))
        assert differ.mean() < 0.01 and off.mean() < 0.02
    else:
        assert studio._flat.wbvh_nodes is not None    # the packet tracer
        assert not differ.any() and not off.any()
    assert (jids == sel).sum() > 100 and (jids == -1).any()
    # the selection changes the image (the outline highlight)
    assert not np.allclose(plain, img)


def test_studio_camera_and_gizmos_are_jax_bitwise():
    cams = (JCamera(), StudioCamera())
    for c in cams:
        c.move_to([0, 0, 10], [0, 0, 0])
        c.orbit(50.0, 0.0)
        c.zoom(1.0)
        for _ in range(100):
            c.orbit(0, 1000.0)           # the pole clamp
        c.pan(10, -3)
        c.zoom(-2.5)
    (j, t) = cams
    assert (t.distance, t.azimuth, t.elevation) == (
        j.distance, j.azimuth, j.elevation)
    assert np.array_equal(t.target, j.target)
    assert np.array_equal(t.position, j.position)
    assert t.elevation < np.pi / 2
    # gizmos: Cornell's camera plus a second one
    segs = []
    for sc, Cam in ((jscenes, JCamera), (scenes, StudioCamera)):
        scene, _ = sc.make_cornell_scene()
        c = Cam()
        c.move_to([3, 4, 12], [0, 1, 0])
        node = c.attach(scene)
        assert scene.node(node).name == "__studio_camera__"
        segs.append(((jgizmos if Cam is JCamera else camera_gizmo_segments)(
            scene), scene.world_transform(node)))
    (ja, jm), (ta, tm) = segs
    assert ta.shape == ja.shape == (16, 6)
    assert np.array_equal(ta, ja) and np.array_equal(tm, jm)


def test_picking_returns_jax_ids():
    (jscene, jstudio), (scene, studio) = _studios("colonnade_small")
    picks = [(x, y) for x in range(0, W, 7) for y in range(0, H, 5)]
    got = [studio.readback_object_id_at(x, y) for x, y in picks]
    assert got == [jstudio.readback_object_id_at(x, y) for x, y in picks]
    assert len(set(got)) > 2 and -1 in got


def test_studio_defaults_to_the_card():
    scene, _ = scenes.make_cornell_scene()
    if torch.cuda.is_available():
        assert StudioRenderer(scene).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StudioRenderer(scene)


def test_preview_command_matches_the_jax_cli(tmp_path, capsys):
    from PIL import Image

    argv = ["preview", "colonnade-small", "--size", f"{W}x{H}", "--pick",
            "32,30", "--select", "9"]
    jpath, path = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jcli.main(argv + ["-o", jpath])
    jout = capsys.readouterr().out.split("\n")
    cli.main(argv + ["--device", "cpu", "-o", path])
    out = capsys.readouterr().out.split("\n")
    assert out[0] == jout[0] and out[0].startswith("node at (32,30): ")
    assert out[1] == path
    a = np.asarray(Image.open(jpath), np.int16)
    b = np.asarray(Image.open(path), np.int16)
    assert a.shape == b.shape == (H, W, 3)
    assert np.abs(a - b).max() <= 1


def test_interactive_preview_session(tmp_path):
    """The session of tests/test_studio.py: orbit, zoom, pick, select,
    material and transform edits, a bad attribute, add, env map and
    colour, camera edits, savescene, a progressive render of 2 spp
    through the preview ladder, save, quit."""
    from platinum_tpu.core.texture import Texture as JTexture
    from platinum_tpu.io.sceneio import load_scene as jload
    from platinum_tpu_torch.io.exr import write_exr

    out = str(tmp_path / "view.png")
    save = str(tmp_path / "kept.png")
    scn = str(tmp_path / "session.ptscene")
    sky = str(tmp_path / "sky.exr")
    grad = np.linspace(0.2, 2.0, 8, dtype=np.float32)
    write_exr(sky, np.broadcast_to(grad[None, :, None], (4, 8, 3)))
    script = "\n".join([
        "pick 16 16", "orbit 0.4 0.1", "zoom -2.0", "select 1",
        "mat 1 roughness=0.25 metallic=1.0 base_color=0.9,0.6,0.2",
        "move 1 0.1 0.0 0.1",
        "mat 1 bogus_attr=1",
        "add cube crate",
        f"env {sky} 1.5",
        "env color 0.2,0.3",
        "env color 0.2,0.3,0.4 2.0",
        "cam focal_length=80 aperture=2.8 focus_distance=12",
        "cam bogus=1",
        "cam sensor_size=36",
        f"savescene {scn}",
        "render 2",
        f"save {save}",
        "quit",
    ]) + "\n"
    proc = subprocess.run(
        [sys.executable, "-m", "platinum_tpu_torch.app.cli", "preview",
         "cornell", "--interactive", "--size", "64x64", "--device", "cpu",
         "-o", out],
        input=script, capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    stdout = proc.stdout
    assert "ready" in stdout and "picked 1" in stdout
    assert "mat " in stdout and "moved 1" in stdout
    assert "added cube" in stdout
    assert "env color" in stdout and f"env {sky}" in stdout
    assert "cam aperture focal_length focus_distance" in stdout
    # bogus_attr, short env color, cam bogus, cam sensor_size
    assert stdout.count("error:") == 4
    assert "preview frame 4" in stdout and "progress 1.00" in stdout
    assert "rendered 2 spp" in stdout
    assert stdout.count("frame ") >= 8
    assert "scene saved" in stdout and stdout.rstrip().endswith("bye")
    assert os.path.exists(out) and os.path.exists(save)
    # the replaced env map was released; JAX reads the saved scene
    saved = jload(scn)
    assert not any(isinstance(data, JTexture)
                   for _, data, *_ in saved.all_assets())
    assert any(saved.node(n).name == "crate" for n in saved._nodes)
