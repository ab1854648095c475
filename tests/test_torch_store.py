"""The port's store and scene formats (app/store.py, io/sceneio.py,
io/refscene.py, io/hdr.py: host copies) against the JAX package's.

- `.ptscene`: what JAX's save_scene writes, the port loads to the same
  scene (the port's own save of it is byte for byte JAX's file, and it
  flattens to the port-built scene's arrays), and what the port saves
  from its own scenes module is byte for byte what JAX saves from its own
  (Cornell, the textured spheres with an HDR environment, the small
  colonnade, the checker-cut golden scene, the 24-instance scene).
- The reference app's format: the spec-built fixture of
  tests/test_refscene.py loads in both packages to the same scene.
- `.hdr`: write_hdr's bytes and read_hdr's floats bitwise JAX's, on files
  it writes and on new-style RLE scanlines of runs and literals.
- Store: the deferred selection and removal of tests/test_store.py,
  open / save_as, import_gltf, import_texture of an EXR, and of a PNG with
  Pillow hidden (io/png.py decodes it), equal to JAX's Store with Pillow.
"""

import os
import sys

import numpy as np
import pytest
import torch

from alpha_scenes import cutout_scene
from instanced_scenes import instanced_scene
from platinum_tpu.io import hdr as jhdr
from platinum_tpu.io import sceneio as jsceneio
from platinum_tpu_torch.app.store import NodeAction, Store
from platinum_tpu_torch.core import primitives
from platinum_tpu_torch.core.scene import RemoveMode
from platinum_tpu_torch.io import hdr, sceneio

torch.set_num_threads(1)


def _builtin(pkg, name):
    import importlib

    sc = importlib.import_module(f"{pkg}.app.scenes")
    return {
        "cornell": lambda: sc.make_cornell_scene(),
        "spheres": lambda: sc.make_spheres_scene(grid=3),
        "colonnade_small": lambda: sc.make_colonnade_scene(
            columns=4, rows=2, sphere_res=(10, 14)),
        "cutout": lambda: cutout_scene(pkg),
        "instanced": lambda: instanced_scene(pkg),
    }[name]()


SCENES = ["cornell", "spheres", "colonnade_small", "cutout", "instanced"]


def _files(path):
    out = []
    for p in (path, os.path.splitext(path)[0] + "_data.bin"):
        with open(p, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("name", SCENES)
def test_ptscene_files_are_the_jax_packages(name, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "again").mkdir()
    jpath = str(tmp_path / "jax" / "s.ptscene")
    path = str(tmp_path / "port" / "s.ptscene")
    again = str(tmp_path / "again" / "s.ptscene")
    jscene, _ = _builtin("platinum_tpu", name)
    jsceneio.save_scene(jscene, jpath)
    scene, _ = _builtin("platinum_tpu_torch", name)
    sceneio.save_scene(scene, path)
    # the port's save of its own scene is JAX's file, byte for byte
    assert _files(path) == _files(jpath)
    # JAX's file loads in the port to a scene that saves to the same bytes
    loaded = sceneio.load_scene(jpath)
    sceneio.save_scene(loaded, again)
    assert _files(again) == _files(jpath)
    # and JAX loads the port's file back to its own bytes
    jsceneio.save_scene(jsceneio.load_scene(path), again)
    assert _files(again) == _files(jpath)
    assert loaded.node_count == scene.node_count
    env, ref = loaded.environment, scene.environment
    assert (env.pdf is None) == (ref.pdf is None)
    if env.pdf is not None:
        assert np.array_equal(env.pdf, ref.pdf)


@pytest.mark.parametrize("name", ["cornell", "spheres", "colonnade_small"])
def test_loaded_ptscene_flattens_to_the_built_scene(name, tmp_path):
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    path = str(tmp_path / "s.ptscene")
    jscene, _ = _builtin("platinum_tpu", name)
    jsceneio.save_scene(jscene, path)
    loaded = sceneio.load_scene(path)
    scene, cam = _builtin("platinum_tpu_torch", name)
    s = RenderSettings(width=16, height=16)
    a = flatten_scene(loaded, loaded.get_cameras()[0][0], s, device="cpu")
    b = flatten_scene(scene, cam, s, device="cpu")
    import dataclasses

    def leaves(x, y, path=""):
        for f in dataclasses.fields(x):
            p, q = getattr(x, f.name), getattr(y, f.name)
            if dataclasses.is_dataclass(p):
                yield from leaves(p, q, f"{path}.{f.name}")
            elif isinstance(p, torch.Tensor):
                yield f"{path}.{f.name}", p, q

    n = 0
    for leaf, p, q in leaves(a, b):
        # bit for bit: some float tables carry integer bits (NaN patterns)
        assert p.dtype == q.dtype and p.shape == q.shape, leaf
        assert torch.equal(p.reshape(-1).view(torch.uint8),
                           q.reshape(-1).view(torch.uint8)), leaf
        n += 1
    assert n > 20


def test_reference_scene_loads_as_in_jax(tmp_path):
    from test_refscene import _write_fixture

    from platinum_tpu.core.scene import Scene as JScene
    from platinum_tpu.io.refscene import load_reference_scene as jload
    from platinum_tpu_torch.core.scene import Scene
    from platinum_tpu_torch.io.refscene import (is_reference_scene,
                                                load_reference_scene)

    path, truth = _write_fixture(str(tmp_path))
    assert is_reference_scene(path)
    jscene, scene = JScene(), Scene()
    jload(jscene, path)
    load_reference_scene(scene, path)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    jsceneio.save_scene(jscene, str(tmp_path / "a" / "r.ptscene"))
    sceneio.save_scene(scene, str(tmp_path / "b" / "r.ptscene"))
    assert (_files(str(tmp_path / "a" / "r.ptscene"))
            == _files(str(tmp_path / "b" / "r.ptscene")))
    mesh = scene.asset(scene.node(scene.node(Scene.ROOT).children[0]).mesh_id)
    np.testing.assert_array_equal(mesh.positions, truth["pos"])
    assert np.array_equal(scene.environment.pdf, jscene.environment.pdf)


def _rle_file(path, rgbe):
    """A new-style RLE .hdr of (H, W, 4) RGBE bytes: each channel of each
    scanline as runs (of 3 or more equal bytes) and literal dumps."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            col, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and col[x + run] == col[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, int(col[x])])
                    x += run
                else:
                    n = min(128, w - x)
                    out += bytes([n]) + col[x:x + n].tobytes()
                    x += n
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("shape", [(5, 9), (7, 40), (3, 4)])
def test_hdr_is_the_jax_codec_bitwise(shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 100, shape + (3,)).astype(np.float32)
    img[0, :3] = 0.0                               # zero pixels: e = 0
    a, b = str(tmp_path / "j.hdr"), str(tmp_path / "p.hdr")
    jhdr.write_hdr(a, img)
    hdr.write_hdr(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back, jback = hdr.read_hdr(b), jhdr.read_hdr(a)
    assert back.dtype == np.float32 and back.shape == img.shape
    assert np.array_equal(back.view(np.uint32), jback.view(np.uint32))
    rgbe = hdr._float_to_rgbe(img)
    assert np.array_equal(rgbe, jhdr._float_to_rgbe(img))
    if shape[1] < 8:
        return          # too narrow for RLE scanlines: flat rows only
    # RLE: runs of constant bytes and literal stretches
    rgbe[:, : shape[1] // 2, 3] = 130              # a run in every row
    path = str(tmp_path / "rle.hdr")
    _rle_file(path, rgbe)
    dec, jdec = hdr.read_hdr(path), jhdr.read_hdr(path)
    assert np.array_equal(dec.view(np.uint32), jdec.view(np.uint32))
    assert np.array_equal(dec, hdr._rgbe_to_float(rgbe))


def _store_with_nodes(n=3):
    store = Store()
    mesh = store.scene.add_asset(primitives.cube(1.0))
    ids = []
    for k in range(n):
        node = store.scene.create_node(f"n{k}")
        store.scene.set_mesh(node.id, mesh)
        ids.append(node.id)
    return store, ids


def test_store_deferred_selection_and_removal():
    store, ids = _store_with_nodes()
    store.select_node(ids[1])
    assert store.selected_node is None      # not applied mid-frame
    store.update()
    assert store.selected_node == ids[1]
    store.remove_node(ids[1])
    assert ids[1] in store.scene             # still present mid-frame
    assert store.get_node_action() == (NodeAction.REMOVE, ids[1])
    action, nid = store.update()
    assert action == NodeAction.REMOVE and nid == ids[1]
    assert ids[1] not in store.scene
    assert store.selected_node is None       # cleared by the removal
    assert store.get_node_action() == (NodeAction.NONE, store.scene.ROOT)
    # a removal that fails still clears the slot
    store.remove_node(12345)
    with pytest.raises(Exception):
        store.update()
    assert store.get_node_action() == (NodeAction.NONE, store.scene.ROOT)


def test_store_remove_modes_and_primitives_under_the_selection():
    store, ids = _store_with_nodes(1)
    child = store.scene.create_node("child", parent=ids[0])
    store.remove_node(ids[0], RemoveMode.MOVE_TO_PARENT)
    store.update()
    assert ids[0] not in store.scene
    assert store.scene.node(child.id).parent == store.scene.ROOT
    store.select_node(child.id)
    store.update()
    nid = store.create_primitive("ball", primitives.sphere(0.5, 8, 6))
    assert store.scene.node(nid).parent == child.id
    assert store.scene.node(nid).mesh_id is not None


def test_store_open_save_and_imports(tmp_path):
    from platinum_tpu_torch.core.texture import TextureFormat
    from platinum_tpu_torch.io.exr import write_exr

    store, ids = _store_with_nodes(2)
    store.select_node(ids[1])
    store.update()
    path = str(tmp_path / "s.ptscene")
    store.save_as(path)
    store.open(path)
    assert store.selected_node is None        # a fresh scene
    assert len(store.scene.get_instances()) == 2
    fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                           "spheres_grid3.glb")
    roots = store.import_gltf(fixture)
    assert roots and len(store.scene.get_instances()) > 2
    p = str(tmp_path / "e.exr")
    img = np.random.default_rng(0).uniform(0, 4, (6, 7, 3)).astype(np.float32)
    write_exr(p, img)
    tex = store.scene.asset(store.import_texture(p))
    assert tex.format == TextureFormat.HDR
    np.testing.assert_allclose(tex.data[..., :3], img, atol=1e-3)


def test_import_texture_reads_a_png_without_pillow(tmp_path, monkeypatch):
    from PIL import Image

    from platinum_tpu.app.store import Store as JStore

    p = str(tmp_path / "t.png")
    arr = np.random.default_rng(4).integers(0, 256, (8, 5, 4), np.uint8)
    Image.fromarray(arr).save(p)
    jstore = JStore()
    ref = jstore.scene.asset(jstore.import_texture(p))
    monkeypatch.setitem(sys.modules, "PIL", None)      # Pillow is gone
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    store = Store()
    tex = store.scene.asset(store.import_texture(p))
    assert tex.data.dtype == np.uint8 and tex.width == 5
    assert np.array_equal(tex.data, ref.data)
    assert tex.has_alpha == ref.has_alpha
    assert tex.format.value == ref.format.value
    assert tex.name == ref.name == "t"
