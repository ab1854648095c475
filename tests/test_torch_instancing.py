"""Two-level instancing in platinum_tpu_torch vs the JAX package, on the
24-instance scene of tests/test_tlas.py (built by each package's own
scene graph): the instanced FlatScene leaf for leaf, the plain version of
K3 against JAX's K3 in interpret mode (hit agreement >= 99.5%, t to
1e-4, instance ids equal where the triangles are), the instanced render
against JAX's under the slice's bars, the instanced render against the
port's own baked render in expectation, and a transform edit refit in
place against a rebuild."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instanced_scenes import instanced_scene
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.accel.tlas import update_instance_transform
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3
INST = dict(width=48, height=48, instancing="on", tracer="packet")


def _leaves(port, ref, path=""):
    for f in dataclasses.fields(port):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        name = f"{path}.{f.name}"
        if dataclasses.is_dataclass(p):
            yield from _leaves(p, r, name)
        elif isinstance(p, torch.Tensor):
            yield name, p, r
        else:
            assert p == r or (p is None and r is None), name


def _rays(r, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def flats():
    jscene, jcam = instanced_scene("platinum_tpu")
    jflat = jflatten(jscene, jcam, JSettings(**INST), accel_min_tris=1)
    scene, cam = instanced_scene("platinum_tpu_torch")
    flat = flatten_scene(scene, cam, RenderSettings(**INST),
                         accel_min_tris=1, device="cpu")
    return jflat, flat


def test_instanced_flatten_matches_jax_leaf_for_leaf(flats):
    jflat, flat = flats
    ref = jax.tree.map(np.asarray, jflat)
    assert flat.instances is not None and flat.instances.feat.shape[0] == 24
    for port in (flat, flat_from_numpy(ref, "cpu")):
        n = 0
        for name, p, r in _leaves(port, ref):
            got = p.numpy()
            assert got.dtype == r.dtype and got.shape == r.shape, name
            assert np.array_equal(got, r, equal_nan=True), name
            n += 1
        assert n > 40
    assert analyze_features(flat) == janalyze(ref)


def test_plain_k3_matches_jax_k3_in_interpret_mode(flats):
    jflat, flat = flats
    o, d = _rays(2048, 7)
    jc, ja = jintegrator.make_tracers(jflat, JSettings(**INST))
    rj = jax.jit(lambda o, d: jc(o, d, 1e-3, jnp.inf))(o, d)
    oj = np.asarray(jax.jit(lambda o, d: ja(o, d, 1e-3, 6.0))(o, d))
    tc, ta = integrator.make_tracers(flat, RenderSettings(**INST))
    rp = tc(torch.from_numpy(o), torch.from_numpy(d), 1e-3, float("inf"))
    op = ta(torch.from_numpy(o), torch.from_numpy(d), 1e-3, 6.0).numpy()

    hj, hp = np.asarray(rj.hit), rp.hit.numpy()
    assert (hj == hp).mean() >= 0.995
    both = hj & hp
    assert both.sum() > 100
    np.testing.assert_allclose(rp.t.numpy()[both], np.asarray(rj.t)[both],
                               rtol=1e-4, atol=1e-4)
    same = rp.tri.numpy()[both] == np.asarray(rj.tri)[both]
    assert same.mean() >= 0.995
    inst = rp.inst.numpy()[both]
    np.testing.assert_array_equal(inst[same], np.asarray(rj.inst)[both][same])
    assert inst.min() >= 0 and inst.max() <= 23
    assert (op == oj).mean() >= 0.995 and op.sum() > 100


def test_instanced_tree_without_inst_feat_is_refused(flats):
    _, flat = flats
    with pytest.raises(ValueError, match="inst_feat"):
        pt.make_packet_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                              flat.wbvh_meta, flat.wbvh_slot)


def _hold(img, ref):
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_RTOL


def test_instanced_render_matches_jax():
    kw = dict(INST, width=32, height=32, spp=2, max_bounces=4, kernel="mis",
              sampler="halton")
    jset = JSettings(**kw)
    jflat = jflatten(*instanced_scene("platinum_tpu"), jset, accel_min_tris=1)
    n = jset.num_pixels
    ref = np.asarray(jintegrator.render_step_n(
        jflat, jset, jnp.zeros((n, 3)), jnp.int32(0), kw["spp"],
        features=janalyze(jflat)))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    img = integrator.render_step_n(flat, RenderSettings(**kw),
                                   torch.zeros((n, 3)), 0, kw["spp"],
                                   features=analyze_features(flat)).numpy()
    assert ref.mean() > 0.0
    _hold(img, ref)


def test_instanced_render_matches_baked_in_expectation():
    """tests/test_tlas.py:96-119 on the port: the instanced render (plain
    K3 on the CPU) against the baked soup through the brute tracer."""
    scene, cam = instanced_scene("platinum_tpu_torch")
    imgs = {}
    for mode, tracer in (("on", "packet"), ("off", "brute")):
        settings = RenderSettings(width=32, height=32, spp=4, max_bounces=4,
                                  sampler="pcg4d", kernel="mis",
                                  instancing=mode, tracer=tracer)
        flat = flatten_scene(scene, cam, settings, accel_min_tris=1,
                             device="cpu")
        assert (flat.instances is not None) == (mode == "on")
        imgs[mode] = integrator.render(
            flat, settings, features=analyze_features(flat)).numpy()
    a, b = imgs["on"], imgs["off"]
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) / b.mean() < 0.01
    assert np.median(np.abs(a - b)) < 5e-3


def test_update_instance_transform_refit_matches_rebuild():
    """tests/test_tlas.py:122-165 on the port, through the Renderer: an
    edit refits the tree in place, and its closest hits match a fresh
    flatten of the moved scene; the instance rows match the rebuild's."""
    scene, cam = instanced_scene("platinum_tpu_torch", n_inst=12,
                                 emissive=False, seed=3)
    settings = RenderSettings(width=8, height=8, spp=2, max_bounces=2,
                              instancing="on", tracer="packet")
    r = Renderer(scene, device="cpu")
    r.start_render(cam, settings)
    r.render()
    node_id = r._host_accel["instances"][5].node_id
    r.update_instance_transform(node_id, Transform(
        translation=[2.0, 1.0, -1.5], rotation=[0.3, 0.2, 0.1],
        scale=[1.4] * 3))
    assert r._accumulated == 0                    # accumulation restarts
    fresh = flatten_scene(scene, cam, settings, accel_min_tris=32,
                          device="cpu")
    torch.testing.assert_close(r.flat.instances.rows, fresh.instances.rows,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r.flat.instances.feat, fresh.instances.feat,
                               rtol=1e-5, atol=1e-6)
    o, d = (torch.from_numpy(x) for x in _rays(1024, 1))
    refit, _ = integrator.make_tracers(r.flat, settings)
    rebuilt, _ = integrator.make_tracers(fresh, settings)
    r1 = refit(o, d, 1e-3, float("inf"))
    r2 = rebuilt(o, d, 1e-3, float("inf"))
    assert (r1.hit == r2.hit).float().mean() >= 0.995
    both = r1.hit & r2.hit
    torch.testing.assert_close(r1.t[both], r2.t[both], rtol=1e-4, atol=1e-4)
    assert (r1.inst[both] == 5).any()
    r.render()
    assert np.isfinite(r.readback()).all()


def test_host_refit_keeps_the_structure_valid():
    """accel.tlas.update_instance_transform on the host arrays: only the
    moved instance's BLAS rows and the TLAS rows change."""
    scene, cam = instanced_scene("platinum_tpu_torch", n_inst=12,
                                 emissive=False, seed=3)
    host = {}
    flatten_scene(scene, cam, RenderSettings(**INST), accel_min_tris=1,
                  device="cpu", host_accel_out=host)
    ibvh = host["ibvh"]
    before = ibvh.nodes.copy()
    m = np.eye(4)
    m[:3, 3] = (1.0, 2.0, 3.0)
    update_instance_transform(ibvh, host["mesh_wides"], 4, m)
    changed = np.nonzero((ibvh.nodes != before).any(axis=1))[0]
    base = int(ibvh.inst_node_base[4])
    n4 = len(host["mesh_wides"][int(ibvh.inst_mesh[4])].nodes)
    assert set(changed) <= set(range(ibvh.n_tlas_nodes)) | set(
        range(base, base + n4))
    assert np.array_equal(ibvh.inst_feat[4, :, 9], [0, 0, 0, 0, 0, 0,
                                                     -1.0, -2.0, -3.0, 1.0])
