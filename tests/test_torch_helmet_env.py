"""The `helmet_env` configuration on the CPU: a textured, normal-mapped,
self-emitting asset under an HDR sky (portbench/generators/helmet.py),
and NEE over textured emitters.

- the generator's shell has the asset's triangle count, is closed, and
  its maps have the glTF slots' encodings and ranges; the generator and
  the plain reference (portbench/reference/helmet_env.py) import nothing
  of the program, of JAX or of the JAX package;
- the small helmet (64 x 64 maps, a 64 x 32 sky, 500 triangles) rendered
  by the Renderer at 48 x 27 is held against the plain reference under
  the cell's limits;
- one emissive quad whose emission texture is half black and half lit,
  over a receiver: NEE's radiance is the factor times the texel at the
  point it samples, and the MIS estimate (NEE and BSDF hits weighted)
  agrees with the BSDF-only one within 3% at 2,048 samples a pixel (the
  two read 1% apart there); the parent's NEE (the factor alone) and the
  parent's MIS weight (from the textured emission) each miss by more
  than 5% (12% and more);
- untextured emitters (the colonnade) keep the parent's light rows and
  give the same sample bit for bit as the parent's `sample_area_light`;
- the new spans and counters record while tracing is on and cost nothing
  while it is off; a sample of the helmet neither copies from the host
  nor reads the device but for the sampler's index and the live checks;
- on a CUDA device (skipped without one): the small helmet's three
  consecutive samples through the captured bounce graphs, bit for bit
  against eager, with the same counts.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from platinum_tpu_torch.models import lights as lights_mod
from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops import samplers as smp
from platinum_tpu_torch.ops.frame import cross, dot, normalize
from platinum_tpu_torch.ops.texturing import sample_atlas
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings
from platinum_tpu_torch.utils import telemetry
from portbench import compare, harness, scenes
from portbench.reference import helmet_env as ref

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_telemetry import _count_blocking  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR = os.path.join(ROOT, "portbench", "generators", "helmet.py")
REFERENCE = os.path.join(ROOT, "portbench", "reference", "helmet_env.py")
SMALL = dict(tex=64, sky_size=(32, 64), triangles=500, columns=16)
CELL = harness.load_json(os.path.join(ROOT, "portbench", "checks",
                                      "helmet_env.final_1080p.json"))
CONFIG = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                        "helmet_env.json"))


def _gen():
    return scenes.load_file(GENERATOR, "test_helmet_")


@pytest.fixture(scope="module")
def small():
    return _gen().make(**SMALL)


def _settings(w=48, h=27, **kw):
    return RenderSettings(**dict(width=w, height=h, spp=1 << 30,
                                 **dict(CONFIG["settings"], **kw)))


# ---------------------------------------------------------------------------
# The generator and the reference
# ---------------------------------------------------------------------------

def test_the_shell_has_the_assets_triangles_and_is_closed():
    mesh = _gen().shell()
    idx = mesh["indices"].astype(np.int64)
    assert idx.shape == (15452, 3)
    assert abs(len(mesh["positions"]) - 14556) < 0.02 * 14556
    # closed: every edge, by position, is shared by two triangles
    key = np.unique(mesh["positions"], axis=0, return_inverse=True)[1]
    tri = key.reshape(-1)[idx]
    edges = np.sort(np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]],
                                    tri[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert mesh["uvs"].min() >= 0.0 and mesh["uvs"].max() <= 1.0
    n = mesh["normals"]
    assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    assert set(np.unique(mesh["tangents"][:, 3])) <= {-1.0, 1.0}


def test_the_maps_keep_their_slots_encodings(small):
    tex = small["textures"]
    assert {k: v["format"] for k, v in tex.items()} == dict(
        albedo="srgb_rgba", metal_rough="rough_metal", normal="linear_rgba",
        emissive="srgb_rgba", sky="hdr")
    assert all(tex[k]["data"].dtype == np.uint8 and
               tex[k]["data"].shape[:2] == (64, 64)
               for k in ("albedo", "metal_rough", "normal", "emissive"))
    rough = tex["metal_rough"]["data"][..., 0] / 255.0
    assert rough.min() >= 0.05 - 1 / 255 and rough.max() <= 0.95 + 1 / 255
    nrm = tex["normal"]["data"][..., :3] / 127.5 - 1.0
    assert (nrm[..., 2] >= np.cos(np.radians(31))).all()
    lit = (tex["emissive"]["data"][..., :3] > 0).any(-1).mean()
    assert 0.01 < lit < 0.1
    sky = tex["sky"]["data"]
    assert sky.shape == (32, 64, 3) and sky.dtype == np.float32
    m = small["materials"]["helmet"]
    assert (m["metallic"], m["roughness"], m["emission"],
            m["emission_strength"]) == (1.0, 1.0, (1.0, 1.0, 1.0), 1.0)


def _imports(path):
    """The modules a file imports (`from a import b` gives a.b where that
    is a module file, else a)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                out.add(sub if os.path.exists(_file(sub)) else node.module)
    return out


def _file(mod):
    return os.path.join(ROOT, *mod.split(".")) + ".py"


def test_generator_and_reference_import_nothing_of_the_program():
    """Followed through the portbench modules they reach: numpy, torch
    and portbench alone."""
    seen, todo = set(), [GENERATOR, REFERENCE]
    while todo:
        path = todo.pop()
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top in ("__future__", "os", "importlib", "numpy", "torch",
                           "portbench"), (path, mod)
            if top == "portbench" and mod not in seen:
                seen.add(mod)
                if os.path.exists(_file(mod)):
                    todo.append(_file(mod))
    assert {"portbench.reference.pathtracer",
            "portbench.testcell.reference.direct_light"} <= seen


@pytest.mark.parametrize("seed", [3400000003, 2**31 + 17])
def test_the_small_helmet_agrees_with_the_reference(small, seed):
    """The Renderer's running mean (warm sample 0 resumed as s0 samples,
    then three steps) at the seed's drawn pixels against the plain
    reference: within the cell's limits, and the light rows matched bit
    for bit."""
    import io

    s = _settings()
    scene, cam = harness.port_scene(small)
    r = Renderer(scene, device="cpu")
    r.start_render(cam, s)
    assert r.flat.lights.packed.shape == (500, 24)
    r.render()
    first = 1 + seed % harness.FIRST_SAMPLES
    buf = io.BytesIO()
    np.savez(buf, buckets=r.readback().reshape(1, -1, 3), accumulated=first)
    buf.seek(0)
    r.load_checkpoint(buf)
    steps = 3
    for _ in range(steps):
        r.render()
    acc = r.readback().reshape(-1, 3)
    rows = r.flat.lights.packed[:int(r.flat.lights.count), :9].numpy()
    pixels = compare.draw_pixels(seed, s.num_pixels, CELL["pixels"])
    acc_ref, _, gap = compare.reference_image(
        ref, small, dict(width=s.width, height=s.height,
                         max_bounces=s.max_bounces),
        pixels, first, steps, rows, "cpu")
    nums = compare.numbers(CELL, acc[pixels], acc_ref.numpy(), light_gap=gap)
    table, correct = compare.judge(CELL, nums)
    assert correct, table
    assert nums["light_rows"] == 0.0 and nums["gap_median"] < 1e-5
    assert acc_ref.mean() > 0.01


# ---------------------------------------------------------------------------
# One textured emitter over a receiver
# ---------------------------------------------------------------------------

LAMP = dict(at=(0.3, 1.0, 0.0), size=(2.0, 1.5), factor=2.0)


def _quad_arrays(lit: int):
    """A diffuse floor under a lamp quad whose 2 x 2 emission texture is
    black in its left column and `lit` (sRGB u8) in its right: filtered,
    the lamp's emission runs from black to lit and back across u."""
    glow = np.zeros((2, 2, 4), np.uint8)
    glow[..., 3] = 255
    glow[:, 1:, :3] = lit
    sx, sz = LAMP["size"]
    f = LAMP["factor"]
    return dict(
        meshes=dict(plane=scenes.plane(1.0)),
        materials=dict(
            floor=dict(base_color=(0.8, 0.8, 0.8, 1.0), roughness=0.7),
            lamp=dict(base_color=(0.0, 0.0, 0.0, 1.0), emission=(f, f, f),
                      textures=dict(emission="glow"))),
        instances=[("floor", "plane", "floor", (0.0, 0.0, 0.0),
                    (0.0, 0.0, 0.0), (6.0, 1.0, 6.0)),
                   ("lamp", "plane", "lamp", LAMP["at"], (0.0, 0.0, 0.0),
                    (sx, 1.0, sz))],
        camera=dict(position=(0.0, 0.5, 2.0), target=(0.0, 0.0, 0.0),
                    focal_length=50.0, sensor_size=(36.0, 24.0),
                    focus_distance=2.0),
        textures=dict(glow=dict(data=glow, format="srgb_rgba")))


def _quad_flat(lit: int, **kw):
    scene, cam = harness.port_scene(_quad_arrays(lit))
    s = RenderSettings(**dict(dict(
        width=4, height=4, spp=1, max_bounces=2, kernel="mis",
        sampler="halton", tracer="brute"), **kw))
    return flatten_scene(scene, cam, s, device="cpu"), s


def _old_sample_area_light(geometry, lights, hit_pos, u_select, u2, *_):
    """The parent's sample_area_light, frozen: the factor alone."""
    n = lights.packed.shape[0]
    scaled = u_select * n
    slot = torch.clamp(scaled.long(), max=n - 1)
    frac = torch.clamp(scaled - slot.to(torch.float32), 0.0, 1.0)
    row = lookup.rows(lights.packed, slot)
    take_alias = frac >= row[..., 14]
    alias = row[..., 15].long()
    idx = torch.where(take_alias, alias, slot)
    row = lookup.rows(lights.packed, idx)
    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    emission = row[..., 9:12]
    area = row[..., 12]
    p_light = row[..., 13]
    b = smp.sample_tri_uniform(u2)
    pos = v0 + e1 * b[..., 0:1] + e2 * b[..., 1:2]
    nrm = normalize(cross(e1, e2))
    delta = pos - hit_pos
    dist2 = torch.sum(delta * delta, dim=-1)
    dist = torch.sqrt(dist2)
    wi = delta / torch.clamp(dist[..., None], min=1e-20)
    cos_l = torch.abs(dot(nrm, wi))
    pdf = dist2 / torch.clamp(cos_l * area, min=1e-20)
    return lights_mod.LightSample(li=emission, wi=wi, dist=dist, pdf=pdf,
                                  p_light=p_light)


def _nee_at_floor(flat, fn, n=4096):
    g = torch.Generator().manual_seed(5)
    hit = torch.zeros((n, 3))
    hit[:, 0] = torch.rand(n, generator=g) * 2.0 - 1.0
    hit[:, 2] = torch.rand(n, generator=g) * 2.0 - 1.0
    ls = fn(flat.geometry, flat.lights, hit, torch.rand(n, generator=g),
            torch.rand((n, 2), generator=g), flat.atlas, flat.atlas_table)
    return hit, ls


@pytest.mark.parametrize("lit", [255, 128], ids=["white", "grey"])
def test_nee_emits_the_factor_times_the_texel(lit):
    """li at each NEE point is the factor times the emission texel at the
    uv the point's position gives on the lamp (u along x, v along z)."""
    flat, _ = _quad_flat(lit)
    hit, ls = _nee_at_floor(flat, lights_mod.sample_area_light)
    pos = hit + ls.wi * ls.dist[:, None]
    (cx, _, cz), (sx, sz) = LAMP["at"], LAMP["size"]
    uv = torch.stack([(pos[:, 0] - cx) / sx + 0.5,
                      (pos[:, 2] - cz) / sz + 0.5], -1)
    entry = flat.atlas_table[0].expand(len(uv), 5)
    want = LAMP["factor"] * sample_atlas(flat.atlas, entry, uv)[:, :3]
    torch.testing.assert_close(ls.li, want, rtol=1e-4, atol=1e-4)
    assert ls.li.min() < 0.05 * want.max()
    _, old = _nee_at_floor(flat, _old_sample_area_light)
    assert not torch.allclose(old.li, want, rtol=1e-2, atol=1e-2)


def _direct(lit, kernel, patch=None, monkeypatch=None, batch=2048):
    """Mean radiance of the lamp's direct light on the floor: 4 x 4 pixels,
    `batch` samples each in one wavefront, two bounces."""
    flat, s = _quad_flat(lit, kernel=kernel, spp_batch=batch)
    if patch is not None:
        monkeypatch.setattr(*patch)
    out = integrator.render_sample(flat, s, 0,
                                   features=analyze_features(flat))
    return float(out.sum() / (3 * batch * s.num_pixels))


@pytest.mark.parametrize("lit", [255, 128], ids=["white", "grey"])
def test_mis_over_a_textured_emitter_agrees_with_bsdf_sampling(
        lit, monkeypatch):
    """MIS (NEE and BSDF hits, weighted) against BSDF sampling alone:
    within 3%; the parent's NEE and the parent's MIS weight each miss by
    more than 5%."""
    bsdf_only = _direct(lit, "simple")
    assert abs(_direct(lit, "mis") / bsdf_only - 1.0) < 0.03
    old_nee = (lights_mod, "sample_area_light", _old_sample_area_light)
    assert _direct(lit, "mis", old_nee, monkeypatch) / bsdf_only > 1.5
    monkeypatch.undo()
    old_pdf = (integrator, "_picked_emission",
               lambda ctx, mats, mat_idx, tex: ctx.emission[:, 1])
    assert _direct(lit, "mis", old_pdf, monkeypatch) / bsdf_only > 1.05


# ---------------------------------------------------------------------------
# Untextured emitters stay as they were
# ---------------------------------------------------------------------------

def _old_light_table(lv0, le1, le2, le):
    """The parent's flatten._light_table rows, frozen."""
    from platinum_tpu_torch.core.environment import build_alias_table

    area = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=-1)
    power = le[:, 1] * area * np.pi
    cum = np.cumsum(power, dtype=np.float64).astype(np.float32)
    _, lp, lalias = build_alias_table(power)
    rows = np.zeros((len(lv0), 16), np.float32)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12] = lv0, le1, le2, le
    rows[:, 12] = area
    rows[:, 13] = power / max(float(cum[-1]), 1e-20)
    rows[:, 14] = lp
    rows[:, 15] = lalias.astype(np.float32)
    return rows


@pytest.fixture(scope="module")
def colonnade():
    from platinum_tpu_torch.app.scenes import make_colonnade_scene

    s = RenderSettings(width=16, height=16, spp=1, max_bounces=3,
                       kernel="mis", tracer="packet", instancing="off")
    scene, cam = make_colonnade_scene(columns=2, rows=2, sphere_res=(8, 12))
    flat = flatten_scene(scene, cam, s, device="cpu")
    return flat, s


def test_untextured_emitters_keep_the_parents_rows_and_sample(
        colonnade, monkeypatch):
    flat, s = colonnade
    geo = flat.geometry.tri_geo.numpy()
    mats = geo[:, 9].astype(np.int64)
    em = flat.materials.emission.numpy()
    lit = (flat.materials.flags.numpy()[mats] & 2) != 0
    rows = _old_light_table(geo[lit, 0:3], geo[lit, 3:6], geo[lit, 6:9],
                            em[mats[lit]])
    assert np.array_equal(flat.lights.packed.numpy(), rows)
    feats = analyze_features(flat)
    tracers = integrator.make_tracers(flat, s)
    new = integrator.render_sample(flat, s, 7, tracers=tracers,
                                   features=feats)
    monkeypatch.setattr(lights_mod, "sample_area_light",
                        _old_sample_area_light)
    old = integrator.render_sample(flat, s, 7, tracers=tracers,
                                   features=feats)
    assert torch.equal(new, old) and new.abs().sum() > 0


def test_the_instanced_path_carries_the_emission_texture():
    """Two instances of the textured lamp (instancing on): each light row
    carries its triangle's uvs and the texture's atlas entry."""
    arrays = _quad_arrays(255)
    arrays["instances"].append(("lamp2", "plane", "lamp", (-0.3, 1.2, 0.5),
                                (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    scene, cam = harness.port_scene(arrays)
    flat = flatten_scene(scene, cam, RenderSettings(
        width=4, height=4, tracer="packet", instancing="on"),
        accel_min_tris=1, device="cpu")
    assert flat.instances is not None
    rows = flat.lights.packed
    assert rows.shape == (4, 24) and (rows[:, 22] == 0).all()
    plane_uv = torch.from_numpy(scenes.plane(1.0)["uvs"])
    got = rows[:, 16:22].reshape(-1, 2)
    assert all(bool((plane_uv == uv).all(-1).any()) for uv in got)


# ---------------------------------------------------------------------------
# Spans, counters, syncs
# ---------------------------------------------------------------------------

def test_the_new_spans_and_counters(small):
    telemetry.drain()
    telemetry.start()
    try:
        scene, cam = harness.port_scene(small)
        r = Renderer(scene, device="cpu")
        r.start_render(cam, _settings(w=16, h=9, compact=False,
                                      compact_plan=None))
        setup = telemetry.drain()
        r.render()
        step = telemetry.drain()
    finally:
        telemetry.stop()
        telemetry.drain()
    spans = {s["name"]: s for s in setup["spans"]}
    assert spans["renderer.env_table"]["texels"] == 32 * 64
    assert "renderer.atlas" in spans
    assert setup["counters"]["flatten.atlas_bytes"] == r.flat.atlas.nbytes
    c = step["counters"]
    # four bound slots and the emitter's texel, four taps each
    assert c["integrator.texture_taps"] == 20 * c["integrator.wave_lanes"]
    assert 0 < c["integrator.env_escapes"] < c["integrator.wave_lanes"]
    assert 0 < c["integrator.env_nee"] < c["integrator.wave_lanes"]


def test_device_counters_launch_nothing_with_tracing_off(monkeypatch):
    def no_sum(*a, **k):
        raise AssertionError("summed with tracing off")

    mask = torch.ones(4, dtype=torch.bool)
    monkeypatch.setattr(torch.Tensor, "sum", no_sum)
    telemetry.stop()
    telemetry.count_device("integrator.env_escapes", mask)
    monkeypatch.undo()
    telemetry.start()
    try:
        telemetry.count_device("integrator.env_escapes", mask)
        assert telemetry.drain()["counters"] == {"integrator.env_escapes": 4}
    finally:
        telemetry.stop()
        telemetry.drain()


def test_a_helmet_sample_syncs_only_to_test_for_live_lanes(small,
                                                            monkeypatch):
    """Textures, the normal map, the sky and textured NEE copy nothing
    from the host and read nothing back inside a bounce."""
    s = _settings(w=16, h=9, compact=False, compact_plan=None)
    scene, cam = harness.port_scene(small)
    flat = flatten_scene(scene, cam, s, device="cpu")
    feats = analyze_features(flat)
    assert {"env", "area_lights", "texslot4", "texslot5"} <= feats
    tracers = integrator.make_tracers(flat, s)
    telemetry.drain()
    telemetry.start()
    try:
        seen, on = _count_blocking(monkeypatch)
        on[0] = True
        integrator.render_sample(flat, s, 5, tracers=tracers, features=feats)
        on[0] = False
        c = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
        telemetry.drain()
    syncs = {k: v for k, v in c.items() if k.startswith("sync.") and v}
    assert set(syncs) == {"sync.live_check", "sync.sample_index"}
    assert sum(syncs.values()) == sum(seen.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_helmet_bounce_graphs_are_the_eager_bounces_bit_for_bit(small):
    """Three consecutive samples of the small helmet through captured
    bounce graphs against eager: radiance and rays bit for bit, the same
    launches and counts."""
    from platinum_tpu_torch.ops import packet_trace as pkt
    from platinum_tpu_torch.render.graphs import BounceGraphs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = _settings(w=320, h=180)
    scene, cam = harness.port_scene(small)
    flat = flatten_scene(scene, cam, s, device="cuda")
    tracers = integrator.make_tracers(flat, s)
    from platinum_tpu_torch.render import autoplan
    s = autoplan.resolve_auto_plan(flat, s, tracers=tracers)
    feats = analyze_features(flat)
    assert integrator.graphs_engage(flat.camera.position.device, tracers, s,
                                    feats)
    graphs = BounceGraphs()
    got = {}
    telemetry.drain()
    telemetry.start()
    try:
        for path in ("eager", "graphs"):
            before = dict(pkt.LAUNCHES)
            runs = [integrator.render_sample(
                flat, s, 11 + i, tracers=tracers, return_stats=True,
                features=feats, graphs=graphs if path == "graphs" else None)
                for i in range(3)]
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in pkt.LAUNCHES.items()
                        if v != before[k]}
            got[path] = (runs, launched, telemetry.drain()["counters"])
    finally:
        telemetry.stop()
        telemetry.drain()
    (eager, e_launch, e_count), (graph, g_launch, g_count) = (
        got["eager"], got["graphs"])
    for (a, ra), (b, rb) in zip(eager, graph):
        assert torch.equal(a, b) and torch.equal(ra, rb)
    assert g_launch == e_launch and e_launch
    for k in ("integrator.wave_lanes", "integrator.live_lanes",
              "integrator.env_escapes", "integrator.env_nee",
              "integrator.texture_taps"):
        assert g_count[k] == e_count[k], k
    assert g_count["integrator.graph_captures"] == len(graphs) > 0
    assert g_count["integrator.graph_replays"] >= len(graphs)
