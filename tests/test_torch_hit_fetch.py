"""The hit fetch (csrc/hit_fetch.cu, ops/hitdata.py `fetch_hit`) against
the plain code it replaces: `interpolate_hit` and the material row reads
(`material_rows`).

On the CPU: `fetch_hit` on CPU tensors is the plain code bit for bit and
`make_shading_context` forms the context from its rows;
the wrapper refuses what the kernel does not take; and the source
itself, compiled for the host by tools/torch_emulate_kernels.py, is held
to the plain code. On the card (marker `gpu`, skipped without a CUDA
device): the kernel against the plain code on the same CUDA tensors,
every launch counted; a shaded bounce through the captured graphs bit
for bit against eager, on world-space geometry and on the two-level
path.

The cases are numpy-made lanes over a random triangle soup: a fifth of
them misses (triangle -1, which reads row 0), vertex normals around each
face normal, tangents of either handedness, some zero and some nearly
parallel to the normal (the frame's fallback), degenerate triangles
(edges in line), with and without the energy-average rows and the atlas
entries; and the soup as a two-level mesh library under a few instances
(rotations, mirrors, uneven scales; material slots past the instance's
last, which clamp to it). This module imports no JAX."""

import dataclasses
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from platinum_tpu_torch.models import bsdf
from platinum_tpu_torch.ops import hitdata
from platinum_tpu_torch.ops.intersect import HitRecord
from platinum_tpu_torch.utils import telemetry

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_emulate_kernels as emu  # noqa: E402

# uv, the hit point, the material index and the rows are the plain code's
# bits (the same operations in the same order, one rounding each, the hit
# point in float64). The normalised vectors (normal, gnormal, the frame,
# wo) differ from it by the order of a three-term sum: both are held to
# the plain code run in float64, within RTOL / ATOL on every lane (the
# BSDF kernel's tolerance, tests/test_torch_bsdf_kernel.py). The cases
# keep every lane off the frame's two branch thresholds (|n.t| = 0.9,
# |n.x| = 0.5) by MARGIN in float64, so float32 and float64 take the same
# branch, and the normals' blends away from cancellation.
RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-3
CASES = {
    # sponza_class and bistro_class: energy rows, no atlas
    "colonnade": dict(avg=True, textures=False),
    # helmet_env: an atlas, the LUTs
    "helmet": dict(avg=False, textures=True),
    "both": dict(avg=True, textures=True),
    # the two-level path (instancing="on"): the instance transform, the
    # material slots
    "instanced": dict(avg=True, textures=True, inst=True),
}
BITS = ("pos", "uv", "mat_idx")
FLOATS = ("normal", "gnormal", "wo", "frame_t", "frame_b")


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _instances(rng, n_inst, slots, mats):
    """(I, 24) instance rows (A, its inverse transpose, the node id) and
    the (I, S) slot table, as render/flatten.py lays them out."""
    rows = np.zeros((n_inst, 24), np.float32)
    for i in range(n_inst):
        q, _ = np.linalg.qr(rng.normal(0, 1, (3, 3)))   # a mirror or not
        a = q @ np.diag(rng.uniform(0.5, 2.0, 3))
        rows[i, 0:9] = a.reshape(-1)
        rows[i, 9:18] = np.linalg.inv(a).T.reshape(-1)
        rows[i, 18] = i
    slot_mat = rng.integers(0, mats, (n_inst, slots)).astype(np.float32)
    return rows, slot_mat


def _case(n, seed, dev, avg=True, textures=True, inst=False, tris=300,
          mats=7, n_inst=5, slots=3):
    """(geometry, materials, rec, o, d, instances): a soup of `tris`
    triangles over `mats` materials and n lanes of hits on it;
    `instances` None, or with `inst` the soup as a mesh library of
    `slots` material slots under `n_inst` instances."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (tris, 3))
    e1 = rng.uniform(-1, 1, (tris, 3))
    e2 = rng.uniform(-1, 1, (tris, 3))
    e2[::37] = 2.0 * e1[::37]                    # degenerate: edges in line
    geo = np.zeros((tris, 12), np.float32)
    geo[:, 0:3], geo[:, 3:6], geo[:, 6:9] = v0, e1, e2
    # a material, or with `inst` a slot (the last two past the instance's
    # slots: clamped to its last)
    geo[:, 9] = rng.integers(0, slots + 2 if inst else mats, tris)
    geo[:, 10] = rng.integers(0, 50, tris)
    face = _unit(np.cross(e1, e2 + 1e-3))
    shade = np.zeros((tris, 24), np.float32)
    for k in range(3):
        shade[:, 3 * k:3 * k + 3] = _unit(face + rng.normal(0, 0.25,
                                                            (tris, 3)))
    tan = _unit(np.cross(face, rng.normal(0, 1, (tris, 3))))
    kind = rng.random(tris)
    tan[kind < 0.05] = 0.0                        # no tangent
    near = (kind >= 0.05) & (kind < 0.15)         # nearly the normal
    tan[near] = _unit(face[near] + rng.normal(0, 0.1, (near.sum(), 3)))
    shade[:, 9:12] = tan
    shade[:, 12] = np.where(rng.random(tris) < 0.5, -1.0, 1.0)
    shade[:, 13:19] = rng.uniform(-2, 3, (tris, 6))
    shade[:, 19:24] = rng.uniform(-1, 1, (tris, 5))   # unread
    packed = rng.uniform(0, 2, (mats, 16)).astype(np.float32)
    packed[:, 15] = rng.integers(0, 8, mats)
    energy_avg = rng.uniform(0.05, 1, (mats, 4)).astype(np.float32)
    tex = rng.integers(-1, 12, (mats, 6)).astype(np.int32)

    irows, slot_mat = _instances(rng, n_inst, slots, mats)

    hit = rng.random(n) >= 0.2
    tri = np.where(hit, rng.integers(0, tris, n), -1).astype(np.int32)
    u, v = np.zeros(n), np.zeros(n)
    # misses carry an id past the table: the fetch reads instance 0 there
    lane_inst = np.full(n, n_inst + 3, np.int32)
    redraw = np.ones(n, bool)
    row = shade[np.maximum(tri, 0)].astype(np.float64)
    tan0 = row[:, 9:12] / np.maximum(
        np.linalg.norm(row[:, 9:12], axis=-1, keepdims=True), 1e-20)
    while redraw.any():
        # barycentrics (and instances) drawn again where the frame's branch
        # thresholds lie within MARGIN (`_well_posed`)
        k = int(redraw.sum())
        u[redraw], v[redraw] = rng.random(k), rng.random(k)
        lane_inst[redraw & hit] = rng.integers(0, n_inst, int(
            (redraw & hit).sum()))
        flip = u + v > 1
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        w = 1 - u - v
        nrm = _unit(row[:, 0:3] * w[:, None] + row[:, 3:6] * u[:, None]
                    + row[:, 6:9] * v[:, None])
        tan = tan0
        if inst:
            ir = irows[np.where(hit, lane_inst, 0)].astype(np.float64)
            nrm = _unit(np.einsum("rij,rj->ri", ir[:, 9:18].reshape(-1, 3, 3),
                                  nrm))
            tan = np.einsum("rij,rj->ri", ir[:, 0:9].reshape(-1, 3, 3), tan)
            tan = tan / np.maximum(
                np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)
        ndt = np.abs(np.sum(nrm * tan, -1))
        redraw = (np.abs(ndt - 0.9) <= 2 * MARGIN) | (
            (ndt > 0.9) & (np.abs(np.abs(nrm[:, 0]) - 0.5) <= 2 * MARGIN))
    t = np.where(hit, rng.uniform(1e-3, 40, n), np.inf).astype(np.float32)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(0, 1, (n, 3))).astype(np.float32)

    def f(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    geometry = SimpleNamespace(tri_shade=f(shade), tri_geo=f(geo))
    materials = SimpleNamespace(
        packed=f(packed), energy_avg=f(energy_avg) if avg else None,
        textures=f(tex, torch.int32), energy=None)
    rec = HitRecord(t=f(t), tri=f(tri, torch.int32),
                    bary=f(np.stack([u, v], -1)), hit=f(hit, torch.bool),
                    inst=f(lane_inst, torch.int32) if inst else None)
    instances = (SimpleNamespace(rows=f(irows), slot_mat=f(slot_mat))
                 if inst else None)
    return geometry, materials, rec, f(o), f(d), instances


def _plain(case, textures):
    geometry, materials, rec, o, d, instances = case
    hd = hitdata.interpolate_hit(geometry, rec, o, d, instances=instances)
    return hd, hitdata.material_rows(materials, hd.mat_idx, textures)


def _plain64(case):
    geometry, _, rec, o, d, instances = case
    g64 = SimpleNamespace(tri_shade=geometry.tri_shade.double(),
                          tri_geo=geometry.tri_geo.double())
    rec64 = HitRecord(t=rec.t.double(), tri=rec.tri,
                      bary=rec.bary.double(), hit=rec.hit, inst=rec.inst)
    i64 = (SimpleNamespace(rows=instances.rows.double(),
                           slot_mat=instances.slot_mat)
           if instances is not None else None)
    return hitdata.interpolate_hit(g64, rec64, o.double(), d.double(),
                                   instances=i64)


def _unit64(v):
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-20)


def _well_posed(case):
    """Every lane lies MARGIN off the frame's branch thresholds in
    float64, so the case asks nothing of the float32 rounding there."""
    hd = _plain64(case)
    geometry, _, rec, _, _, instances = case
    tri = torch.where(rec.hit, rec.tri, 0).long()
    tan = _unit64(geometry.tri_shade.double()[tri, 9:12])
    if instances is not None:
        inst = torch.where(rec.hit, rec.inst, 0).long()
        a = instances.rows.double()[inst, 0:9].reshape(-1, 3, 3)
        tan = _unit64(torch.einsum("rij,rj->ri", a, tan))
    ndt = (hd.normal * tan).sum(-1).abs()
    assert ((ndt - 0.9).abs() > MARGIN).all()
    bad = ndt > 0.9
    assert ((hd.normal[bad, 0].abs() - 0.5).abs() > MARGIN).all()
    assert bad.any() and (~bad).any()


def _bits_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _hold(got, case, textures):
    """Hold a (HitData, HitRows) to the plain code on the same tensors:
    the rows, the material index, uv and the hit point bit for bit, the
    normalised vectors within RTOL / ATOL of the plain code in float64."""
    hd, rows = got
    want, want_rows = _plain(case, textures)
    for name in BITS:
        assert _bits_equal(getattr(hd, name), getattr(want, name)), name
    for name in ("mat", "energy_avg", "tex"):
        assert _bits_equal(getattr(rows, name), getattr(want_rows, name)), \
            name
    want64 = _plain64(case)
    n = hd.pos.shape[0]
    for name in FLOATS:
        a, b = getattr(hd, name).double(), getattr(want64, name)
        bad = ((a - b).abs() > ATOL + RTOL * b.abs()).any(-1)
        if bad.any():
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {n} lanes off; lane {i}: "
                f"{a[i].tolist()} against {b[i].tolist()} in float64")


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_take_the_plain_code_bit_for_bit(name):
    case = _case(2048, 5, "cpu", **CASES[name])
    geometry, materials, rec, o, d, instances = case
    textures = CASES[name]["textures"]
    _well_posed(case)
    before = dict(hitdata.LAUNCHES)
    telemetry.drain()
    telemetry.start()
    try:
        hd, rows = hitdata.fetch_hit(geometry, rec, o, d, materials,
                                     textures=textures, instances=instances)
        counters = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
    want, want_rows = _plain(case, textures)
    for f in BITS + FLOATS:
        assert _bits_equal(getattr(hd, f), getattr(want, f)), f
    for f in ("mat", "energy_avg", "tex"):
        assert _bits_equal(getattr(rows, f), getattr(want_rows, f)), f
    assert hitdata.LAUNCHES == before
    assert counters.get("hitfetch.lanes") == 2048
    assert "hitfetch.kernel_lanes" not in counters
    # the context is formed from the fetched rows: the packed row's
    # columns, the energy-average row
    ctx = bsdf.make_shading_context(materials, hd.mat_idx, rows, hd.uv)
    packed = materials.packed[hd.mat_idx.long()]
    for f, cols in (("albedo", slice(0, 3)), ("emission", slice(4, 7)),
                    ("roughness", 7), ("metallic", 8), ("transmission", 9),
                    ("ior", 10), ("anisotropy", 11),
                    ("anisotropy_rotation", 12), ("clearcoat", 13),
                    ("clearcoat_roughness", 14)):
        assert _bits_equal(getattr(ctx, f), packed[:, cols]), f
    assert torch.equal(ctx.flags, packed[:, 15].to(torch.int32))
    assert _bits_equal(ctx.energy_avg_row, want_rows.energy_avg)
    assert ctx.mat_idx is hd.mat_idx


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    geometry, materials, rec, o, d, instances = _case(16, 2, "cpu",
                                                      inst=True)

    def launch(geometry=geometry, materials=materials, rec=rec, o=o, d=d,
               instances=None):
        return hitdata._launch(geometry, rec, o, d, materials, True,
                               instances)

    with pytest.raises(TypeError, match="tri must be torch.int32"):
        launch(rec=HitRecord(t=rec.t, tri=rec.tri.long(), bary=rec.bary,
                             hit=rec.hit))
    with pytest.raises(TypeError, match="hit must be torch.bool"):
        launch(rec=HitRecord(t=rec.t, tri=rec.tri, bary=rec.bary,
                             hit=rec.hit.to(torch.uint8)))
    with pytest.raises(TypeError, match="o must be torch.float32"):
        launch(o=o.double())
    with pytest.raises(ValueError, match="bary must have shape"):
        launch(rec=HitRecord(t=rec.t, tri=rec.tri, bary=rec.bary[:8],
                             hit=rec.hit))
    with pytest.raises(ValueError, match="d must be"):
        launch(d=d[None])
    with pytest.raises(ValueError, match="tri_shade must be a contiguous"):
        launch(geometry=SimpleNamespace(
            tri_shade=geometry.tri_shade[:, :20], tri_geo=geometry.tri_geo))
    with pytest.raises(ValueError, match="materials.packed must be"):
        launch(materials=SimpleNamespace(
            packed=materials.packed.T.contiguous().T,
            energy_avg=materials.energy_avg, textures=materials.textures))
    with pytest.raises(ValueError, match="materials.textures must be"):
        launch(materials=SimpleNamespace(
            packed=materials.packed, energy_avg=materials.energy_avg,
            textures=materials.textures.float()))
    with pytest.raises(TypeError, match="inst must be torch.int32"):
        launch(rec=dataclasses.replace(rec, inst=rec.inst.long()),
               instances=instances)
    with pytest.raises(ValueError, match="instances.rows must be"):
        launch(rec=rec, instances=SimpleNamespace(
            rows=instances.rows[:, :18].contiguous(),
            slot_mat=instances.slot_mat))
    with pytest.raises(ValueError, match="instances.slot_mat must be"):
        launch(rec=rec, instances=SimpleNamespace(
            rows=instances.rows, slot_mat=instances.slot_mat.T))


def test_the_source_reads_the_flattened_rows():
    """The row widths the source assumes are the flattened tables'."""
    import re

    from platinum_tpu_torch.ops import packet_trace as pt

    with open(os.path.join(pt.CSRC_DIR, "hit_fetch.cu")) as f:
        text = f.read()
    consts = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", text)}
    assert (consts["kShade"], consts["kGeo"], consts["kInst"]) == (24, 12, 24)
    assert pt.SOURCE_FLAGS["hit_fetch"] == ["-fmad=false"]
    assert emu.HOST_FLAGS["hit_fetch"] == ("-ffp-contract=off",)


# ---------------------------------------------------------------------------
# The source on the host (tools/torch_emulate_kernels.py)
# ---------------------------------------------------------------------------

HOST_LANES = 4096


@pytest.fixture(scope="module")
def emulated():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    tmp = tempfile.mkdtemp(prefix="emulated_hit_fetch_")
    try:
        yield emu.Emulation(tmp, sources=("hit_fetch",))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_is_the_plain_code(emulated, name):
    case = _case(HOST_LANES, 11, "cpu", **CASES[name])
    _well_posed(case)
    geometry, materials, rec, o, d, instances = case
    textures = CASES[name]["textures"]
    with emulated:
        got = hitdata._launch(geometry, rec, o, d, materials, textures,
                              instances)
    _hold(got, case, textures)


def test_emulated_kernel_reads_fields_where_they_lie(emulated):
    """o, d, bary, t, tri, hit and inst as views of wider rows (any lane
    and component stride) give the same bits as packed tensors."""
    geometry, materials, rec, o, d, instances = _case(1024, 3, "cpu",
                                                      inst=True)
    wide = torch.cat([o, rec.bary, d, rec.t[:, None]], dim=1)
    wide = wide.T.contiguous().T                  # column-major
    ints = torch.stack([rec.tri, rec.hit.int(), rec.inst], dim=1)
    hits = torch.stack([rec.hit, rec.hit], dim=1)
    rec2 = HitRecord(t=wide[:, 8], tri=ints[:, 0], bary=wide[:, 3:5],
                     hit=hits[:, 1], inst=ints[:, 2])
    with emulated:
        a = hitdata._launch(geometry, rec, o, d, materials, True, instances)
        b = hitdata._launch(geometry, rec2, wide[:, 0:3], wide[:, 5:8],
                            materials, True, instances)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            assert _bits_equal(getattr(x, f.name), getattr(y, f.name)), f.name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_LANES = 262_144


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_the_plain_code(card, name):
    case = _case(CARD_LANES, 21, card, **CASES[name])
    _well_posed(case)
    geometry, materials, rec, o, d, instances = case
    textures = CASES[name]["textures"]
    before = hitdata.LAUNCHES["hit_fetch"]
    got = hitdata.fetch_hit(geometry, rec, o, d, materials,
                            textures=textures, instances=instances)
    torch.cuda.synchronize()
    assert hitdata.LAUNCHES["hit_fetch"] == before + 1
    _hold(got, case, textures)


@pytest.mark.gpu
def test_kernel_counts_its_lanes_and_refuses_a_foreign_device(card):
    geometry, materials, rec, o, d, _ = _case(1000, 23, card)
    telemetry.drain()
    telemetry.start()
    try:
        hitdata.fetch_hit(geometry, rec, o, d, materials)
        counters = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
    assert counters["hitfetch.kernel_lanes"] == counters["hitfetch.lanes"] \
        == 1000
    with pytest.raises(ValueError, match="o is on cpu"):
        hitdata.fetch_hit(geometry, rec, o.cpu(), d, materials)
    # an empty wave launches nothing
    geometry, materials, rec, o, d, _ = _case(0, 24, card)
    before = dict(hitdata.LAUNCHES)
    hd, rows = hitdata.fetch_hit(geometry, rec, o, d, materials)
    assert hd.pos.shape == (0, 3) and rows.mat.shape == (0, 16)
    assert hitdata.LAUNCHES == before


def _colonnade(dev, **kw):
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    s = RenderSettings(**dict(dict(
        width=160, height=90, spp=8, max_bounces=4, kernel="mis",
        sampler="halton", tracer="packet", instancing="off"), **kw))
    scene, cam = make_colonnade_scene(columns=4, rows=2, sphere_res=(12, 16))
    flat = flatten_scene(scene, cam, s, device=dev)
    return flat, s, analyze_features(flat), integrator.make_tracers(flat, s)


@pytest.mark.gpu
@pytest.mark.parametrize("instancing", ["off", "on"])
def test_graph_bounces_fetch_as_eager_bit_for_bit(card, instancing):
    """Two samples through captured bounce graphs against eager: radiance
    and rays bit for bit, every shaded lane fetched by the kernel, the
    same launches of it on both paths; on world-space geometry and on the
    two-level path (the instance transform in the kernel)."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.graphs import BounceGraphs

    flat, s, feats, tracers = _colonnade(card, instancing=instancing)
    assert (flat.instances is not None) == (instancing == "on")
    assert integrator.graphs_engage(card, tracers, s, feats)
    graphs = BounceGraphs()
    got = {}
    telemetry.drain()
    telemetry.start()
    try:
        for path in ("eager", "graphs"):
            before = hitdata.LAUNCHES["hit_fetch"]
            runs = [integrator.render_sample(
                flat, s, 3 + i, tracers=tracers, return_stats=True,
                features=feats, graphs=graphs if path == "graphs" else None)
                for i in range(2)]
            torch.cuda.synchronize()
            got[path] = (runs, hitdata.LAUNCHES["hit_fetch"] - before,
                         telemetry.drain()["counters"])
    finally:
        telemetry.stop()
        telemetry.drain()
    (eager, e_n, e_count), (graph, g_n, g_count) = got["eager"], got["graphs"]
    for (a, ra), (b, rb) in zip(eager, graph):
        assert torch.equal(a, b) and torch.equal(ra, rb)
    assert e_n == g_n > 0
    for c in (e_count, g_count):
        assert c["hitfetch.kernel_lanes"] == c["hitfetch.lanes"] > 0
