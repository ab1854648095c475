"""Guards on the port's independence from the JAX package.

- No module of platinum_tpu_torch, not chip_smoke.py and not
  tests/golden_configs.py (the goldens' configurations chip_smoke.py
  renders) imports JAX or anything of the JAX package (read with `ast`,
  one case per file).
- The port imports and renders with the JAX package hidden, and its CLI
  runs `info cornell` so.
- The record of copied modules (COPIES): each copy names the JAX file it
  copies in its docstring, no other module of the port claims to be a
  copy, and a copy marked verbatim is its original statement for statement
  (the docstring and the package name aside).
- Renderer(scene) and flatten_scene default to the card: without one they
  raise instead of falling back to the CPU.
- The port's copies of the scene graph and the BVH builders give bitwise
  the JAX package's binary and wide BVH arrays on the colonnade.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "platinum_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "platinum_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "golden_configs.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imported(tree):
    """Top-level package of every module an import statement names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources())
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(set(_imported(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _cuda_sources():
    csrc = os.path.join(PORT, "csrc")
    return sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))


@pytest.mark.parametrize("name", _cuda_sources())
def test_cuda_source_includes_only_the_toolkit_and_the_package(name):
    """A kernel source builds from the checkout and the CUDA toolkit
    alone: every #include names a toolkit / C header or a header of
    csrc/ itself, so no generated or JAX-side file can slip in."""
    import re

    csrc = os.path.join(PORT, "csrc")
    with open(os.path.join(csrc, name)) as f:
        includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]',
                              f.read(), re.M)
    assert includes, f"{name} includes nothing"
    for kind, header in includes:
        if kind == "<":
            assert header in ("cuda_runtime.h", "cuda_bf16.h", "stdint.h"), (
                f"{name} includes <{header}>")
        else:
            assert os.path.exists(os.path.join(csrc, header)), (
                f'{name} includes "{header}", not in csrc/')


def test_every_cuda_source_is_package_data():
    """csrc/*.cu and *.cuh ship with the package (pyproject.toml), or an
    installed port could not build its kernels."""
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        text = f.read()
    assert {"wide_trace.cu", "stream_mt.cu", "mt_block.cuh"} <= set(
        _cuda_sources())
    for ext in {os.path.splitext(n)[1] for n in _cuda_sources()}:
        assert f"csrc/*{ext}" in text, f"csrc/*{ext} is not package data"


# The port's copies of JAX modules: True where the copy is its original
# statement for statement (docstring and package name aside), else what
# differs.
COPIES = {
    "accel/__init__.py": True,
    "accel/bvh.py": True,
    "accel/native.py": "builds the library under a private name, renames",
    "accel/partition.py": "make_partitioned_tracer is torch, over the "
                          "port's packet tracer",
    "accel/tlas.py": True,
    "accel/wide.py": True,
    "app/scenes.py": "three function docstrings reworded",
    "app/store.py": "import_texture decodes PNGs through io/png.py, "
                    "not Pillow",
    "core/camera.py": True,
    "core/colorspace.py": True,
    "core/environment.py": True,
    "core/material.py": True,
    "core/mesh.py": True,
    "core/mikkt.py": "remembers its last results by input bytes",
    "core/primitives.py": True,
    "core/scene.py": True,
    "core/texture.py": "has_alpha, where the caller does not give it, "
                       "follows the glTF loader's rule (scan_alpha of an "
                       "srgb_rgba map)",
    "core/transform.py": True,
    "io/exr.py": True,
    "io/gltf.py": "decodes textures through io/png.py; leaves has_alpha "
                  "to Texture's default, which is its rule",
    "io/hdr.py": True,
    "io/icc.py": True,
    "io/refscene.py": True,
    "io/sceneio.py": True,
    "post/options.py": True,
    "tools/foreign_glb.py": "encodes textures through io/png.py",
    "tools/gltf_export.py": "encodes textures through io/png.py",
    "tools/import_luts.py": True,
    "utils/matrices.py": True,
    "utils/telemetry.py": "adds the port's spans and counters (span, count, "
                          "count_device, start, stop, drain, summary, "
                          "log_spans)",
}


def _statements(path, package):
    with open(path) as f:
        tree = ast.parse(f.read())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree).replace(package, "platinum_tpu")


def test_copy_record_is_complete():
    claimed = set()
    for path in _sources():
        with open(os.path.join(REPO, path)) as f:
            if f.read().startswith('"""Copy of platinum_tpu/'):
                claimed.add(os.path.relpath(path, "platinum_tpu_torch"))
    assert claimed == set(COPIES)


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_names_its_original(rel):
    with open(os.path.join(PORT, rel)) as f:
        head = f.readline()
    assert head.startswith(f'"""Copy of platinum_tpu/{rel}, kept in step')
    assert os.path.exists(os.path.join(REPO, "platinum_tpu", rel))


@pytest.mark.parametrize("rel", sorted(r for r, v in COPIES.items()
                                       if v is True))
def test_verbatim_copy_is_its_original(rel):
    assert _statements(os.path.join(PORT, rel), "platinum_tpu_torch") == \
        _statements(os.path.join(REPO, "platinum_tpu", rel), "platinum_tpu")


BLOCK_JAX = (
    "import importlib, importlib.abc, pkgutil, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'platinum_tpu'):\n"
    "            raise ImportError(f'blocked: {name}')\n"
    "sys.meta_path.insert(0, Block())\n")


def _run_hidden(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_runs_with_the_jax_package_hidden():
    """A fresh interpreter in which importing `platinum_tpu` or `jax`
    fails imports every module of the port, flattens Cornell with the
    port's own scenes module and renders one small sample on the CPU."""
    code = (
        "import platinum_tpu_torch\n"
        "for m in pkgutil.walk_packages(platinum_tpu_torch.__path__,"
        " 'platinum_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "from platinum_tpu_torch.app.scenes import make_cornell_scene\n"
        "from platinum_tpu_torch.render.renderer import Renderer\n"
        "from platinum_tpu_torch.render.types import RenderSettings\n"
        "scene, cam = make_cornell_scene()\n"
        "r = Renderer(scene, device='cpu')\n"
        "r.start_render(cam, RenderSettings(width=8, height=8, spp=1,"
        " max_bounces=2))\n"
        "r.render()\n"
        "img = r.readback()\n"
        "print(img.shape, bool((img >= 0).all()), img.mean() > 0)\n")
    proc = _run_hidden(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "(8, 8, 3) True True"


def test_cli_info_runs_with_the_jax_package_hidden():
    proc = _run_hidden("from platinum_tpu_torch.app import cli\n"
                       "cli.main(['info', 'cornell'])\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["triangles"] == 12


def test_entry_points_default_to_the_card():
    from platinum_tpu_torch.app.scenes import make_cornell_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.renderer import Renderer

    scene, cam = make_cornell_scene()
    if torch.cuda.is_available():
        assert Renderer(scene).device.type == "cuda"
        assert flatten_scene(scene, cam).camera.position.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flatten_scene(scene, cam)
    assert Renderer(scene, device="cpu").device.type == "cpu"


def test_copied_builders_give_the_jax_package_bvh_bitwise():
    from platinum_tpu.accel import get_builder as jbuilder
    from platinum_tpu.accel.wide import build_wide_bvh as jwide
    from platinum_tpu.app.scenes import make_colonnade_scene as jcolonnade
    from platinum_tpu_torch.accel import get_builder
    from platinum_tpu_torch.accel.wide import build_wide_bvh
    from platinum_tpu_torch.app.scenes import make_colonnade_scene

    def soup(scene):
        tris = []
        for inst in scene.get_instances():
            m = inst.transform
            p = (inst.mesh.positions @ m[:3, :3].T + m[:3, 3]).astype(
                np.float32)
            tris.append(p[inst.mesh.indices])
        return np.concatenate(tris)

    a, b = soup(jcolonnade()[0]), soup(make_colonnade_scene()[0])
    np.testing.assert_array_equal(a, b)
    assert len(a) == 271_010
    built = []
    for builder, wide in ((jbuilder(), jwide), (get_builder(), build_wide_bvh)):
        bvh = builder(a[:, 0], a[:, 1], a[:, 2], max_leaf=4)
        o = bvh.tri_order
        geo = np.concatenate([a[o, 0], a[o, 1] - a[o, 0], a[o, 2] - a[o, 0],
                              np.zeros((len(o), 3), np.float32)], -1)
        built.append((bvh, wide(bvh, geo, leaf_cap=64)))
    (jb, jw), (pb, pw) = built
    for name in ("bounds_lo", "bounds_hi", "skip", "tri_start", "tri_count",
                 "tri_order"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    for name in ("nodes", "meta", "tri_blocks", "tri_of_slot"):
        np.testing.assert_array_equal(getattr(pw, name), getattr(jw, name))
