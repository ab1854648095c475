"""The port's partitioned scenes against the JAX package's, on the CPU.

- `partition_bvh`: every partition bitwise JAX's on a random soup.
- `make_partitioned_tracer`: the port's (the plain K1/K2 versions on CPU
  tensors) against JAX's (Pallas interpret mode): `hit`, `tri` and `t`
  bit for bit at "highest"; occlusion equal. Also against the port's
  single-structure tracer: the same hits, t bit for bit (the same
  per-triangle arithmetic), ids equal outside exact-t ties.
- `fold_closest`: an exact-t tie keeps the earlier partition's hit, and
  `inst_override` replaces the instance ids, as JAX's does.
- `partition_instanced` and the partitioned flatten (baked and instanced,
  the small colonnade and tests/test_tlas.py's 24-instance scene): every
  array of every partition bitwise JAX's, the instance maps the groups.
- `tracer="bf"` over partitions raises (JAX's falls through to brute).
- A partitioned 16x16 render against JAX's at tests/test_torch_slice.py's
  bars; the partitioned transform edit against JAX's Renderer, array for
  array; `render_sample(pixel_ids=)` against JAX's on a strided subset of
  8,192 lanes, with and without compaction: (R, 3) rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instanced_scenes import instanced_scene
from platinum_tpu.accel.bvh import build_bvh as jbuild_bvh
from platinum_tpu.accel.partition import make_partitioned_tracer as jpart_tracer
from platinum_tpu.accel.partition import partition_bvh as jpartition_bvh
from platinum_tpu.app.scenes import make_colonnade_scene as jcolonnade
from platinum_tpu.app.scenes import make_cornell_scene as jcornell
from platinum_tpu.core.transform import Transform as JTransform
from platinum_tpu.ops.intersect import HitRecord as JHitRecord
from platinum_tpu.ops.intersect import fold_closest as jfold
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.renderer import Renderer as JRenderer
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.accel.bvh import build_bvh
from platinum_tpu_torch.accel.partition import (make_partitioned_tracer,
                                                partition_bvh)
from platinum_tpu_torch.accel.wide import build_wide_bvh
from platinum_tpu_torch.app.scenes import (make_colonnade_scene,
                                           make_cornell_scene)
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.ops.intersect import HitRecord, fold_closest
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
TMIN, TMAX_ANY = 1e-3, 8.0
PIX_RTOL, PIX_ATOL, PIX_FRACTION = 2e-3, 2e-3, 0.995  # test_torch_slice.py
MEAN_RTOL = 1e-3
BAKED = dict(width=16, height=16, tracer="packet", partition_tris=800,
             instancing="off", stream="off")
INSTANCED = dict(width=8, height=8, spp=1, instancing="on", tracer="packet",
                 partition_bytes=60_000, stream="off")


def _soup(t, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-6, 6, (t, 3)).astype(np.float32)
    return tuple(c + rng.normal(0, 0.25, (t, 3)).astype(np.float32)
                 for _ in range(3))


def _rays(r, seed=3, span=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (r, 3)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_partition_bvh_is_jaxs_bitwise():
    soup = _soup(6000)
    parts = partition_bvh(build_bvh(*soup, max_leaf=4), budget_tris=1500)
    ref = jpartition_bvh(jbuild_bvh(*soup, max_leaf=4), budget_tris=1500)
    assert len(parts) == len(ref) >= 3
    for p, r in zip(parts, ref):
        assert (p.tri_base, p.tri_count) == (r.tri_base, r.tri_count)
        for f in dataclasses.fields(r.bvh):
            a, b = getattr(p.bvh, f.name), getattr(r.bvh, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.fixture(scope="module")
def soup_parts():
    """A 2,400-triangle soup in partitions of <= 900, each packed as
    render/flatten.py packs one (slot map globalised), and the whole soup
    packed as one structure."""
    t = 2400
    v0, v1, v2 = _soup(t, seed=5)
    bvh = build_bvh(v0, v1, v2, max_leaf=4)
    o = bvh.tri_order
    tri_geo = np.concatenate([v0[o], v1[o] - v0[o], v2[o] - v0[o],
                              np.zeros((t, 3), np.float32)], -1)
    arrays = []
    for p in partition_bvh(bvh, budget_tris=900):
        w = build_wide_bvh(p.bvh, tri_geo[p.tri_base:p.tri_base + p.tri_count],
                           leaf_cap=16)
        slot = np.where(w.tri_of_slot >= 0, w.tri_of_slot + p.tri_base, -1)
        arrays.append((w.nodes, w.tri_blocks, w.meta, slot.astype(np.int32)))
    return arrays, build_wide_bvh(bvh, tri_geo, leaf_cap=16)


def test_partitioned_tracer_is_jaxs_bitwise(soup_parts):
    arrays, _ = soup_parts
    assert len(arrays) >= 3
    o, d = _rays(1024)
    jc, ja = jpart_tracer([tuple(jnp.asarray(a) for a in p) for p in arrays])
    ref = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(jnp.asarray(o),
                                                          jnp.asarray(d))
    occ_ref = np.asarray(jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(
        jnp.asarray(o), jnp.asarray(d)))
    tc, ta = make_partitioned_tracer(
        [tuple(torch.from_numpy(a) for a in p) for p in arrays])
    launches = dict(pt.LAUNCHES)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = tc(to, td, TMIN, float("inf"))
    assert got.hit.sum() > 100
    for k in ("hit", "tri", "t"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(ref, k))), k
    assert np.array_equal(ta(to, td, TMIN, TMAX_ANY).numpy(), occ_ref)
    assert pt.LAUNCHES == launches      # CPU tensors never reach the kernel


def test_partitioned_tracer_is_the_single_structure(soup_parts):
    arrays, wide = soup_parts
    tc, ta = make_partitioned_tracer(
        [tuple(torch.from_numpy(a) for a in p) for p in arrays])
    sc, sa = pt.make_packet_tracer(
        torch.from_numpy(wide.nodes), torch.from_numpy(wide.tri_blocks),
        torch.from_numpy(wide.meta),
        torch.from_numpy(wide.tri_of_slot.astype(np.int32)))
    o, d = (torch.from_numpy(x) for x in _rays(2048, seed=9))
    active = torch.from_numpy(np.random.default_rng(1).random(2048) < 0.8)
    a = tc(o, d, TMIN, float("inf"), active=active)
    b = sc(o, d, TMIN, float("inf"), active=active)
    assert torch.equal(a.hit, b.hit) and not a.hit[~active].any()
    assert torch.equal(a.t, b.t)
    apart = a.hit & (a.tri != b.tri)
    assert int(apart.sum()) <= 2          # exact-t ties only
    assert torch.equal(ta(o, d, TMIN, TMAX_ANY, active=active),
                       sa(o, d, TMIN, TMAX_ANY, active=active))


def _records(seed, n=512, inst=True):
    rng = np.random.default_rng(seed)
    t = rng.choice([1.0, 2.0, 3.0, np.inf], n).astype(np.float32)
    rec = dict(t=t, tri=np.where(np.isfinite(t), rng.integers(0, 99, n),
                                 -1).astype(np.int32),
               hit=np.isfinite(t), bary=rng.random((n, 2), dtype=np.float32))
    if inst:
        rec["inst"] = rng.integers(0, 7, n).astype(np.int32)
    return rec


def test_fold_keeps_the_earlier_partition_on_exact_ties():
    """Two partitions' records: on an exact-t tie the earlier record's
    triangle stays; `inst_override` (the remapped ids) replaces rec.inst
    where the later record is closer; bitwise JAX's fold."""
    a, b = _records(3), _records(4)
    b["t"][:64] = a["t"][:64]             # exact ties
    b["hit"][:64] = a["hit"][:64]
    override = (b["inst"] + 100).astype(np.int32)
    got = fold_closest(HitRecord(**{k: torch.from_numpy(v)
                                    for k, v in a.items()}),
                       HitRecord(**{k: torch.from_numpy(v)
                                    for k, v in b.items()}),
                       inst_override=torch.from_numpy(override))
    ref = jfold(JHitRecord(**{k: jnp.asarray(v) for k, v in a.items()}),
                JHitRecord(**{k: jnp.asarray(v) for k, v in b.items()}),
                inst_override=jnp.asarray(override))
    for k in ("t", "tri", "hit", "bary", "inst"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(ref, k))), k
    tie = a["hit"][:64]
    assert np.array_equal(got.tri.numpy()[:64][tie], a["tri"][:64][tie])
    closer = b["hit"] & (b["t"] < a["t"])
    assert np.array_equal(got.inst.numpy()[closer], override[closer])
    assert np.array_equal(got.inst.numpy()[~closer], a["inst"][~closer])


def _parts_equal(port_parts, ref_parts):
    assert len(port_parts) == len(ref_parts)
    n = 0
    for p, r in zip(port_parts, ref_parts):
        assert len(p) == len(r)
        for a, b in zip(p, r):
            b = np.asarray(b)
            a = a.cpu().numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b)
            n += 1
    return n


def _flats(kind):
    """(port FlatScene, JAX FlatScene as numpy, port host_accel_out), each
    flattened by its own package from its own scenes module."""
    if kind == "baked":
        jscene, jcam = jcolonnade(columns=4, rows=2, sphere_res=(10, 14))
        scene, cam = make_colonnade_scene(columns=4, rows=2,
                                          sphere_res=(10, 14))
        kw = BAKED
    else:
        jscene, jcam = instanced_scene("platinum_tpu")
        scene, cam = instanced_scene("platinum_tpu_torch")
        kw = INSTANCED
    ref = jax.tree.map(np.asarray, jflatten(jscene, jcam, JSettings(**kw),
                                            accel_min_tris=1))
    host = {}
    flat = flatten_scene(scene, cam, RenderSettings(**kw), accel_min_tris=1,
                         host_accel_out=host, device="cpu")
    return flat, ref, host


@pytest.mark.parametrize("kind", ["baked", "instanced"])
def test_partitioned_flatten_is_jaxs_bitwise(kind):
    flat, ref, host = _flats(kind)
    assert flat.wbvh_nodes is None and ref.wbvh_nodes is None
    assert len(flat.wbvh_parts) >= 2
    n = _parts_equal(flat.wbvh_parts, ref.wbvh_parts)
    assert n == len(flat.wbvh_parts) * (5 if kind == "baked" else 7)
    for name in ("tri_geo", "indices", "positions"):
        assert np.array_equal(getattr(flat.geometry, name).numpy(),
                              getattr(ref.geometry, name))
    if kind == "instanced":
        assert np.array_equal(flat.instances.feat.numpy(), ref.instances.feat)
        # partition_instanced: each partition's local ids map to its group
        gids = [np.asarray(g) for _, g, _ in host["ibvh_parts"]]
        assert sorted(np.concatenate(gids).tolist()) == list(range(24))
        for part, g in zip(flat.wbvh_parts, gids):
            assert np.array_equal(part[6].numpy(), g.astype(np.int32))
            assert np.array_equal(part[5].numpy(),
                                  flat.instances.feat.numpy()[g])
    moved = flat.to("cpu")          # TensorStruct carries the nested tuple
    _parts_equal(moved.wbvh_parts, ref.wbvh_parts)
    _parts_equal(flat_from_numpy(ref, "cpu").wbvh_parts, ref.wbvh_parts)


def test_bf_tracer_refuses_partitions():
    """tracer="bf" over a partitioned scene raises the refusal of JAX
    integrator.py:73-75. JAX's make_tracers never reaches that refusal for
    partitions (they leave wbvh_nodes None) and falls through to its
    brute-force tracer; the port refuses rather than hand the trace to a
    plain version on the card."""
    kw = dict(BAKED, tracer="bf")
    flat = flatten_scene(*make_colonnade_scene(columns=4, rows=2,
                                               sphere_res=(10, 14)),
                         RenderSettings(**kw), accel_min_tris=1,
                         device="cpu")
    assert flat.wbvh_parts is not None and flat.wbvh_nodes is None
    with pytest.raises(ValueError, match="no partitioning"):
        integrator.make_tracers(flat, RenderSettings(**kw))


def test_partitioned_render_matches_jax():
    """Cornell in partitions of <= 4 triangles, 16x16 x 2 spp: the port's
    render of JAX's FlatScene (carried across) against JAX's, at
    tests/test_torch_slice.py's bars; and the port's partitioned render
    equals its single-structure render."""
    kw = dict(width=16, height=16, spp=2, max_bounces=3, sampler="pcg4d",
              tracer="packet", instancing="off", partition_tris=4,
              stream="off")
    jscene, jcam = jcornell()
    jflat = jflatten(jscene, jcam, JSettings(**kw), accel_min_tris=1)
    assert len(jflat.wbvh_parts) >= 2
    feats = janalyze(jflat)
    ref = np.asarray(jintegrator.render(jflat, JSettings(**kw),
                                        features=feats))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    img = integrator.render(flat, RenderSettings(**kw),
                            features=feats).numpy()
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert np.isfinite(img).all() and close.mean() >= PIX_FRACTION
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_RTOL
    one = dict(kw, partition_tris=350_000)
    single = flatten_scene(*make_cornell_scene(), RenderSettings(**one),
                           accel_min_tris=1, device="cpu")
    assert single.wbvh_parts is None
    np.testing.assert_array_equal(
        integrator.render(single, RenderSettings(**one),
                          features=feats).numpy(), img)


def test_partitioned_transform_edit_is_jaxs():
    """The same edit on both Renderers over the partitioned 24-instance
    scene: the owning partition refit, its 7-tuple and the instance tables
    bitwise JAX's; the other partitions untouched; the tracer pair rebuilt
    over the new arrays traces like a fresh flatten of the moved scene."""
    jscene, jcam = instanced_scene("platinum_tpu", emissive=False, seed=3)
    scene, cam = instanced_scene("platinum_tpu_torch", emissive=False, seed=3)
    jr = JRenderer(jscene)
    jr.start_render(jcam, JSettings(**INSTANCED))
    r = Renderer(scene, device="cpu")
    r.start_render(cam, RenderSettings(**INSTANCED))
    before = [tuple(a.clone() for a in p) for p in r.flat.wbvh_parts]
    node_id = r._host_accel["instances"][5].node_id
    edit = dict(translation=[2.0, 1.0, -1.5], rotation=[0.3, 0.2, 0.1],
                scale=[1.4] * 3)
    jr.update_instance_transform(node_id, JTransform(**edit))
    r.update_instance_transform(node_id, Transform(**edit))
    ref = jax.tree.map(np.asarray, jr.flat)
    _parts_equal(r.flat.wbvh_parts, ref.wbvh_parts)
    for name in ("rows", "slot_mat", "feat"):
        assert np.array_equal(getattr(r.flat.instances, name).numpy(),
                              getattr(ref.instances, name)), name
    changed = [not all(torch.equal(a, b) for a, b in zip(p, q))
               for p, q in zip(r.flat.wbvh_parts, before)]
    assert sum(changed) == 1
    fresh = flatten_scene(scene, cam, RenderSettings(**INSTANCED),
                          accel_min_tris=1, device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(1024, seed=1, span=6.0))
    a = r._tracers[0](o, d, TMIN, float("inf"))
    b = integrator.make_tracers(fresh, RenderSettings(**INSTANCED))[0](
        o, d, TMIN, float("inf"))
    assert torch.equal(a.hit, b.hit) and torch.equal(a.t, b.t)
    assert torch.equal(a.inst[a.hit], b.inst[b.hit])


@pytest.fixture(scope="module")
def cornell_pair():
    kw = dict(width=128, height=128, spp=1, max_bounces=5, sampler="pcg4d",
              tracer="brute")
    jscene, jcam = jcornell()
    jflat = jflatten(jscene, jcam, JSettings(**kw))
    return kw, jflat, flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")


@pytest.mark.parametrize("compact", [False, True])
def test_render_sample_pixel_ids_matches_jax(cornell_pair, compact):
    """Every other pixel of a 128x128 Cornell (8,192 lanes: with compact
    the plan has several segments): (R, 3) rows against JAX's at
    tests/test_torch_slice.py's bars; without compaction the rows are the
    full render's bit for bit."""
    kw, jflat, flat = cornell_pair
    kw = dict(kw, compact=compact)
    ids = np.arange(0, kw["width"] * kw["height"], 2, dtype=np.uint32)
    s = RenderSettings(**kw)
    assert len(integrator._compaction_plan(len(ids), s)) == (3 if compact
                                                             else 1)
    feats = janalyze(jflat)
    ref = np.asarray(jax.jit(
        lambda f: jintegrator.render_sample(f, JSettings(**kw), jnp.int32(1),
                                            pixel_ids=jnp.asarray(ids),
                                            features=feats))(jflat))
    got = integrator.render_sample(flat, s, 1,
                                   pixel_ids=torch.from_numpy(ids.astype(
                                       np.int64)), features=feats).numpy()
    assert got.shape == ref.shape == (len(ids), 3)
    close = np.isclose(got, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert np.isfinite(got).all() and close.mean() >= PIX_FRACTION
    assert abs(got.mean() / ref.mean() - 1.0) <= MEAN_RTOL
    if not compact:
        full = integrator.render_sample(flat, s, 1, features=feats).numpy()
        assert np.array_equal(full[ids], got)
