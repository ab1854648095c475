"""The port's glTF path against the JAX package's: io/gltf.py,
tools/foreign_glb.py and the port's PIL-free PNG codec (io/png.py) with its
ICC profiles (io/icc.py).

- Each package loads tests/fixtures/spheres_grid3.glb (one embedded PNG)
  and foreign_quirks.gltf and flattens the result with its own flattener:
  every leaf bitwise equal.
- export_glb_foreign of the small colonnade and of the spheres scene: the
  .glb files are equal byte for byte, except the embedded PNGs (the port
  encodes with filter 0 and zlib, the JAX package with PIL): their
  decoded texels are equal, and so is every other byte (the JSON with the
  buffer views' offsets and lengths left out, every other buffer view).
- The codec: its reader on PNGs PIL writes (colour types 0, 2, 3, 4, 6)
  equals PIL's convert("RGBA"); its writer's file, decoded by PIL, equals
  the JAX write_png's pixels; its iCCP profile is io/icc.profile_for's, which
  is the JAX package's byte for byte.
"""

import io
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from platinum_tpu.app import scenes as jscenes
from platinum_tpu.core.camera import Camera as JCamera
from platinum_tpu.core.scene import Scene as JScene
from platinum_tpu.core.transform import Transform as JTransform
from platinum_tpu.io import icc as jicc
from platinum_tpu.io.gltf import load_gltf as jload_gltf
from platinum_tpu.io.png import write_png as jwrite_png
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu.tools.foreign_glb import export_glb_foreign as jexport
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.io import icc, png
from platinum_tpu_torch.io.gltf import load_gltf
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.types import RenderSettings
from platinum_tpu_torch.tools.foreign_glb import export_glb_foreign
from test_torch_flatten import _assert_equal

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
SPACES = ("sRGB", "DisplayP3", "BT2020")


def _loaded(name, scene_cls, load, camera_cls, transform_cls):
    scene = scene_cls()
    load(scene, os.path.join(FIXTURES, name))
    cams = scene.get_cameras()
    if cams:
        return scene, cams[0][0]
    # foreign_quirks.gltf has no camera: the same one in each package
    node = scene.create_node("test_camera")
    node.camera = camera_cls.with_fov(0.8)
    node.transform = transform_cls(translation=[0.3, 0.5, 4.0])
    return scene, node.id


@pytest.mark.parametrize("name", ["spheres_grid3.glb", "foreign_quirks.gltf"])
def test_loaded_scene_flattens_as_jax_leaf_for_leaf(name):
    kw = dict(width=16, height=16)
    jscene, jcam = _loaded(name, JScene, jload_gltf, JCamera, JTransform)
    ref = jax.tree.map(np.asarray, jflatten(jscene, jcam, JSettings(**kw)))
    scene, cam = _loaded(name, Scene, load_gltf, Camera, Transform)
    flat = flatten_scene(scene, cam, RenderSettings(**kw), device="cpu")
    n = _assert_equal(flat, ref)
    assert n > 40
    if name == "spheres_grid3.glb":
        assert flat.atlas is not None and flat.geometry.indices.shape[0] \
            == 20_162


def _glb(path):
    """(JSON document, BIN chunk) of a .glb file."""
    with open(path, "rb") as f:
        blob = f.read()
    n = struct.unpack_from("<I", blob, 12)[0]
    doc = json.loads(blob[20:20 + n])
    return doc, blob[20 + n + 8:]


def _view(doc, bin_, i):
    v = doc["bufferViews"][i]
    return bin_[v.get("byteOffset", 0):v.get("byteOffset", 0)
                + v["byteLength"]]


@pytest.mark.parametrize("make,args", [
    ("make_colonnade_scene", dict(columns=4, rows=2, sphere_res=(10, 14))),
    ("make_spheres_scene", {})])
def test_foreign_glb_is_the_jax_writers(make, args, tmp_path):
    jexport(getattr(jscenes, make)(**args)[0], str(tmp_path / "jax.glb"))
    export_glb_foreign(getattr(scenes, make)(**args)[0],
                       str(tmp_path / "port.glb"))
    jdoc, jbin = _glb(tmp_path / "jax.glb")
    doc, bin_ = _glb(tmp_path / "port.glb")
    images = {im["bufferView"] for im in doc.get("images", [])}
    assert images == {im["bufferView"] for im in jdoc.get("images", [])}
    if not images:
        with open(tmp_path / "jax.glb", "rb") as a, \
                open(tmp_path / "port.glb", "rb") as b:
            assert a.read() == b.read()
        return
    assert make == "make_spheres_scene"
    for i in range(len(doc["bufferViews"])):
        mine, ref = _view(doc, bin_, i), _view(jdoc, jbin, i)
        if i in images:
            want = np.asarray(Image.open(io.BytesIO(ref)).convert("RGBA"))
            np.testing.assert_array_equal(png.decode_png(mine), want)
            assert png.icc_profile(mine) is None
        else:
            assert mine == ref, i
    for d in (doc, jdoc):
        for v in d["bufferViews"]:
            del v["byteOffset"], v["byteLength"]
        del d["buffers"][0]["byteLength"]
    assert doc == jdoc


def _pil_png(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "png", **kw)
    return buf.getvalue()


def _image(mode, h=29, w=41, seed=0):
    """Noise in the top half (PIL filters such rows with Sub / Up), a
    smooth ramp below (Average / Paeth)."""
    rng = np.random.default_rng(seed)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5)[..., None]
            + 40 * np.arange(ch)) % 256
    img = np.where(np.arange(h)[:, None, None] < h // 2,
                   rng.integers(0, 256, (h, w, ch)), ramp).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("ctype,mode,kw", [
    (0, "L", {}), (0, "L", {"transparency": 7}),
    (2, "RGB", {}), (2, "RGB", {"transparency": (1, 2, 3)}),
    (3, "P", {}), (3, "P", {"transparency": 5}), (3, "P16", {}),
    (4, "LA", {}), (6, "RGBA", {})])
def test_png_reader_is_pils_convert_rgba(ctype, mode, kw):
    if mode.startswith("P"):
        # 200 colours: an 8-bit palette; 16: PIL packs 4 bits an index
        ncol = 16 if mode == "P16" else 200
        rng = np.random.default_rng(1)
        im = Image.fromarray(rng.integers(0, ncol, (29, 41), np.uint8), "P")
        im.putpalette([int(v) for v in rng.integers(0, 256, 3 * ncol)])
        buf = io.BytesIO()
        im.save(buf, "png", **kw)
        data = buf.getvalue()
    else:
        arr = _image(mode)
        if mode == "L" and kw:
            arr[3, :5] = 7
        if mode == "RGB" and kw:
            arr[4, :5] = (1, 2, 3)
        data = _pil_png(arr, mode, **kw)
    ihdr = dict(png.chunks(data))[b"IHDR"]
    assert ihdr[9] == ctype
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("kind", ["float_rgb", "u8_rgb", "u8_rgba", "gray"])
def test_png_writer_pixels_are_the_jax_writers(kind, tmp_path):
    rng = np.random.default_rng(2)
    img = {"float_rgb": rng.uniform(-0.2, 1.2, (17, 23, 3)).astype(
               np.float32),
           "u8_rgb": rng.integers(0, 256, (17, 23, 3), np.uint8),
           "u8_rgba": rng.integers(0, 256, (17, 23, 4), np.uint8),
           "gray": rng.uniform(0, 1, (17, 23)).astype(np.float32)}[kind]
    jwrite_png(str(tmp_path / "jax.png"), img)
    png.write_png(str(tmp_path / "port.png"), img)
    a = Image.open(tmp_path / "jax.png")
    b = Image.open(tmp_path / "port.png")
    assert a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert b.info["icc_profile"] == a.info["icc_profile"]
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")),
                                  np.asarray(a.convert("RGBA")))


@pytest.mark.parametrize("space", SPACES)
def test_iccp_profile_is_profile_for(space, tmp_path):
    assert icc.profile_for(space) == jicc.profile_for(space)
    png.write_png(str(tmp_path / "x.png"), np.zeros((4, 5, 3), np.uint8),
                  output_space=space)
    with open(tmp_path / "x.png", "rb") as f:
        data = f.read()
    assert png.icc_profile(data) == jicc.profile_for(space)
    assert Image.open(tmp_path / "x.png").info["icc_profile"] == \
        jicc.profile_for(space)


def test_texture_decode_needs_pillow_only_beyond_png(monkeypatch):
    """A PNG decodes without Pillow; any other image raises naming the
    image and Pillow when Pillow cannot be imported."""
    import builtins

    jpeg = io.BytesIO()
    Image.fromarray(_image("RGB")).save(jpeg, "jpeg")
    arr = _image("RGBA")
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(
        png.decode_image(_pil_png(arr, "RGBA"), "tex"), arr)
    with pytest.raises(RuntimeError, match="'albedo.jpg'.*Pillow"):
        png.decode_image(jpeg.getvalue(), "albedo.jpg")
