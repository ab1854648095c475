"""platinum_tpu_torch flattener and converter vs the JAX package's: every
array leaf of the FlatScene equal, dtype and values. Each package flattens
a scene built by its own scenes module with the same arguments."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from platinum_tpu.app import scenes as jscenes
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)

SCENES = {
    "cornell": ("make_cornell_scene", {}, dict(width=32, height=32)),
    # the small colonnade: 29,090 triangles, 139 wide nodes
    "colonnade_small": ("make_colonnade_scene", dict(sphere_res=(12, 16)),
                        dict(width=32, height=32, tracer="packet",
                             instancing="off")),
    # procedural: the helmet under its sky array, the spheres with a
    # normal-mapped ground whose texture goes into the atlas
    "helmet": ("make_helmet_scene", {}, dict(width=32, height=32)),
    "spheres": ("make_spheres_scene", {}, dict(width=32, height=32)),
}


def _leaves(port, ref, path=""):
    """Yield (path, port tensor, reference numpy) for every array leaf."""
    for f in dataclasses.fields(port):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        name = f"{path}.{f.name}"
        if dataclasses.is_dataclass(p):
            yield from _leaves(p, r, name)
        elif isinstance(p, torch.Tensor):
            yield name, p, r
        else:
            assert p == r or (p is None and r is None), name


def _assert_equal(port, ref):
    n = 0
    for name, p, r in _leaves(port, ref):
        r = np.asarray(r)
        got = p.cpu().numpy()
        assert got.dtype == r.dtype, (name, got.dtype, r.dtype)
        assert got.shape == r.shape, (name, got.shape, r.shape)
        assert np.array_equal(got, r, equal_nan=True), name
        n += 1
    return n


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    make, args, kw = SCENES[request.param]
    jscene, jcam = getattr(jscenes, make)(**args)
    ref = jax.tree.map(np.asarray, jflatten(jscene, jcam, JSettings(**kw)))
    scene, cam = getattr(scenes, make)(**args)
    return request.param, scene, cam, kw, ref


def test_flatten_matches_jax_leaf_for_leaf(scene_pair):
    name, scene, cam, kw, ref = scene_pair
    flat = flatten_scene(scene, cam, RenderSettings(**kw), device="cpu")
    n = _assert_equal(flat, ref)
    assert n > 40
    if name == "colonnade_small":
        assert flat.geometry.indices.shape[0] == 29_090
        assert flat.wbvh_nodes.shape[0] == 139
    if name == "spheres":
        assert flat.atlas is not None
    assert analyze_features(flat) == janalyze(ref)


def test_flat_from_numpy_matches_jax_leaf_for_leaf(scene_pair):
    _, _, _, _, ref = scene_pair
    _assert_equal(flat_from_numpy(ref, "cpu"), ref)


def test_instanced_flatten_raises_naming_the_roadmap_item():
    """Two-level instancing flattens; an instanced structure over the
    resident budget, which raised until accel/tlas.py's
    partition_instanced was ported, flattens into partitions (each a
    7-tuple; tests/test_torch_partition.py holds them to JAX's)."""
    scene, cam = scenes.make_colonnade_scene(columns=2, rows=2,
                                             sphere_res=(6, 8))
    flat = flatten_scene(scene, cam, RenderSettings(
        tracer="packet", instancing="auto"), device="cpu")
    assert flat.instances is not None and flat.wbvh_parts is None
    parts = flatten_scene(scene, cam, RenderSettings(
        tracer="packet", instancing="auto", stream="off",
        partition_bytes=1 << 16), device="cpu")
    assert parts.wbvh_nodes is None and len(parts.wbvh_parts) >= 2
    assert all(len(p) == 7 for p in parts.wbvh_parts)
    assert torch.equal(parts.instances.feat, flat.instances.feat)
