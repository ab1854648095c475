"""The port's host tools against the JAX package's, on the CPU:
tools/import_luts.py, tools/gltf_export.py and utils/prof.py.

- import_luts: the committed bundle written out in the reference's EXR
  slice layout (101 files), read back by both packages' import_lut_dir:
  the two .npz bundles are equal array for array, bit for bit, and equal
  to the tables written.
- export_glb: Cornell (no texture) is JAX's file byte for byte; the
  textured spheres scene has JAX's JSON apart from the buffer views'
  offsets from the first image on and that image's length (the port
  encodes PNGs with io/png.py, JAX with PIL), equal decoded images and
  every other buffer view equal; the port's loader reads the port's file
  back to the arrays JAX's loader and flattener make of JAX's file.
- prof.measure on a CPU callable: the best third of the repeats, less
  the trivial-call latency, per inner iteration; the default device is
  the card.
"""

import io
import json
import os
import struct
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from platinum_tpu.app import scenes as jscenes
from platinum_tpu.core.scene import Scene as JScene
from platinum_tpu.io.gltf import load_gltf as jload_gltf
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu.tools.gltf_export import export_glb as jexport
from platinum_tpu.tools.import_luts import import_lut_dir as jimport
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.io import png
from platinum_tpu_torch.io.exr import write_exr
from platinum_tpu_torch.io.gltf import load_gltf
from platinum_tpu_torch.ops.luts import LUT_BUNDLE
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.types import RenderSettings
from platinum_tpu_torch.tools.gltf_export import export_glb
from platinum_tpu_torch.tools.import_luts import import_lut_dir
from platinum_tpu_torch.utils import prof
from test_torch_flatten import _assert_equal

torch.set_num_threads(1)


def test_import_luts_reads_the_slices_as_jax_does(tmp_path):
    src = tmp_path / "lut"
    src.mkdir()
    b = np.load(LUT_BUNDLE)
    write_exr(str(src / "ggx_E.exr"), b["E"])
    write_exr(str(src / "ggx_E_avg.exr"), b["E_avg"][None, :])
    for name, key in (("ggx_ms_E", "E_ms"), ("ggx_E_trans_in", "E_trans_in"),
                      ("ggx_E_trans_out", "E_trans_out")):
        for z in range(32):
            write_exr(str(src / f"{name}_{z}.exr"), b[key][z])
    for name, key in (("ggx_ms_E_avg", "E_ms_avg"),
                      ("ggx_E_trans_in_avg", "E_trans_in_avg"),
                      ("ggx_E_trans_out_avg", "E_trans_out_avg")):
        write_exr(str(src / f"{name}.exr"), b[key])
    assert len(os.listdir(src)) == 101
    jout, out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jimport(str(src), jout)
    got = import_lut_dir(str(src), out)
    ref, written = np.load(jout), np.load(out)
    assert sorted(written.files) == sorted(ref.files) == sorted(got)
    assert len(got) == 8
    for key in ref.files:
        assert written[key].dtype == ref[key].dtype == np.float32
        np.testing.assert_array_equal(written[key], ref[key])
        np.testing.assert_array_equal(got[key], b[key])


def _glb(path):
    """(JSON document, BIN chunk) of a .glb file."""
    with open(path, "rb") as f:
        blob = f.read()
    n = struct.unpack_from("<I", blob, 12)[0]
    return json.loads(blob[20:20 + n]), blob[20 + n + 8:]


def _view(doc, bin_, i):
    v = doc["bufferViews"][i]
    return bin_[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]


def test_cornell_export_is_the_jax_file_byte_for_byte(tmp_path):
    jscene, jcam = jscenes.make_cornell_scene()
    scene, cam = scenes.make_cornell_scene()
    jexport(jscene, str(tmp_path / "jax.glb"), jcam)
    assert export_glb(scene, str(tmp_path / "port.glb"), cam) == str(
        tmp_path / "port.glb")
    with open(tmp_path / "jax.glb", "rb") as a, \
            open(tmp_path / "port.glb", "rb") as b:
        ref, mine = a.read(), b.read()
    assert len(mine) > 1000 and mine == ref


def _loaded(path, scene_cls, load):
    scene = scene_cls()
    load(scene, str(path))
    return scene, scene.get_cameras()[0][0]


def test_textured_export_is_the_jax_file_and_loads_back(tmp_path):
    jexport(jscenes.make_spheres_scene(grid=2)[0], str(tmp_path / "jax.glb"))
    export_glb(scenes.make_spheres_scene(grid=2)[0],
               str(tmp_path / "port.glb"))
    jdoc, jbin = _glb(tmp_path / "jax.glb")
    doc, bin_ = _glb(tmp_path / "port.glb")
    images = [im["bufferView"] for im in doc["images"]]
    assert images == [im["bufferView"] for im in jdoc["images"]]
    assert len(images) == 1
    first = images[0]
    for i in range(len(doc["bufferViews"])):
        mine, ref = _view(doc, bin_, i), _view(jdoc, jbin, i)
        if i in images:
            want = np.asarray(Image.open(io.BytesIO(ref)).convert("RGBA"))
            np.testing.assert_array_equal(png.decode_png(mine), want)
        else:
            assert mine == ref, i
    for d in (doc, jdoc):
        for i, v in enumerate(d["bufferViews"]):
            if i >= first:
                del v["byteOffset"]
            if i == first:
                del v["byteLength"]
        del d["buffers"][0]["byteLength"]
    assert doc == jdoc

    # the port's loader and flattener read the port's file back to what
    # JAX's make of JAX's file
    kw = dict(width=16, height=16)
    js, jc = _loaded(tmp_path / "jax.glb", JScene, jload_gltf)
    ref = jax.tree.map(np.asarray, jflatten(js, jc, JSettings(**kw)))
    s, c = _loaded(tmp_path / "port.glb", Scene, load_gltf)
    flat = flatten_scene(s, c, RenderSettings(**kw), device="cpu")
    assert flat.atlas is not None
    assert _assert_equal(flat, ref) > 40


def test_measure_on_a_cpu_callable():
    def run(x, n):
        for _ in range(n):
            x = torch.sin(x)
        return x

    x = torch.linspace(0.0, 1.0, 4096)
    lat = prof.call_latency(device="cpu")
    assert 0.0 < lat < 0.1
    t0 = time.perf_counter()
    m = prof.measure(run, x, 50, iters_inside=50, repeats=6, device="cpu")
    wall = time.perf_counter() - t0
    assert 0.0 < m.total < wall / 6
    assert m.per_iter == pytest.approx(max(0.0, m.total - m.latency) / 50)
    assert m.healthy == (m.latency < 1e-3)
    assert "ms/iter" in str(m)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prof.call_latency()
