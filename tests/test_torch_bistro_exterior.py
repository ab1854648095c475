"""The `bistro_exterior` configuration on the CPU: a street with alpha-cut
leaf cards under an HDR sky (portbench/generators/bistro_exterior.py),
and the cutout path it runs.

- the small street (a few hundred leaf cards, 64 x 64 maps, a 64 x 32
  sky) rendered by the Renderer at 48 x 27 is held against the plain
  reference (portbench/reference/bistro_exterior.py) under the cell's
  limits; its leaves are cutouts, and the reference with them made
  opaque reads further off; the generator and the reference import
  nothing of the program;
- `Texture` infers `has_alpha` by the glTF loader's rule: a cut sRGB
  colour map is a cutout, an opaque one and every other format are not,
  a value the caller gives is kept, and the helmet's maps stay opaque;
- on the cutout scene the alpha counters tie together (passes among the
  hits drawn for, the lanes out of budget among the passes)
  and the rays of `return_stats` grow by exactly the lanes each alpha
  wave queried; a sample of the small street reads nothing on the host
  but the sampler's index and the live checks.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from platinum_tpu_torch.core.texture import Texture, TextureFormat
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings
from platinum_tpu_torch.utils import telemetry
from portbench import compare, harness, scenes
from portbench.reference import bistro_exterior as ref

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from alpha_scenes import checker_texture, cutout_scene  # noqa: E402
from test_torch_helmet_env import _imports  # noqa: E402
from test_torch_telemetry import _count_blocking  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENERATOR = os.path.join(ROOT, "portbench", "generators",
                         "bistro_exterior.py")
REFERENCE = os.path.join(ROOT, "portbench", "reference", "bistro_exterior.py")
SMALL = dict(bays=1, cards=80, bush_cards=60, trees_per_side=3, planters=1,
             tables=1, strings=2, bulbs_per_string=6, cobble=1.0,
             balusters=2, leaf=0.35, tex=64, sky_size=(32, 64))
CELL = harness.load_json(os.path.join(ROOT, "portbench", "checks",
                                      "bistro_exterior.final_1080p.json"))
CONFIG = harness.load_json(os.path.join(ROOT, "portbench", "configs",
                                        "bistro_exterior.json"))


@pytest.fixture(scope="module")
def small():
    return scenes.load_file(GENERATOR, "test_bistro_exterior_").make(**SMALL)


def _settings(w=48, h=27, **kw):
    return RenderSettings(**dict(width=w, height=h, spp=1 << 30,
                                 **dict(CONFIG["settings"], **kw)))


def test_the_small_street_agrees_with_the_reference(small):
    """The Renderer's running mean (warm sample 0 resumed as s0 samples,
    then three steps) at the seed's pixels against the plain reference:
    within the cell's limits, the light rows matched bit for bit; the
    reference with its cutouts made opaque reads further off."""
    seed = 2**31 + 29
    s = _settings()
    scene, cam = harness.port_scene(small)
    r = Renderer(scene, device="cpu")
    r.start_render(cam, s)
    assert "alpha" in r._features
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
    assert rows.shape == (12 * 6 * 2, 9)
    pixels = compare.draw_pixels(seed, s.num_pixels, CELL["pixels"])
    got = {}
    for est in ("gltf", "opaque"):
        samples = [0] + list(range(first, first + steps))
        rad, gap = ref.radiance(small, s.width, s.height, s.max_bounces,
                                pixels, samples, rows, "cpu", estimator=est)
        acc_ref = compare.expected(rad, first)
        got[est] = compare.numbers(CELL, acc[pixels], acc_ref.numpy(),
                                   light_gap=gap)
    table, correct = compare.judge(CELL, got["gltf"])
    assert correct, table
    assert got["gltf"]["light_rows"] == 0.0
    assert got["gltf"]["gap_median"] < 1e-5
    assert got["opaque"]["pixels_off"] > 4 * got["gltf"]["pixels_off"] + 0.02


def test_generator_and_reference_import_nothing_of_the_program():
    for path in (GENERATOR, REFERENCE):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "numpy", "torch",
                                         "portbench"), (path, mod)


def test_the_small_streets_maps(small):
    tex = small["textures"]
    assert {k: v["format"] for k, v in tex.items()} == dict(
        leaves_a="srgb_rgba", leaves_b="srgb_rgba", facade="srgb_rgba",
        sky="hdr")
    for k in ("leaves_a", "leaves_b"):
        a = tex[k]["data"][..., 3]
        assert (a == 0).any() and 0.3 < (a == 255).mean() < 0.7
    assert (tex["facade"]["data"][..., 3] == 255).all()
    bulbs = sum(len(small["meshes"][m]["indices"])
                for _, m, mat, *_ in small["instances"] if mat == "bulb")
    assert bulbs == 12 * 6 * 2


# ---------------------------------------------------------------------------
# Texture.has_alpha
# ---------------------------------------------------------------------------

def test_texture_infers_alpha_by_the_gltf_loaders_rule():
    cut = checker_texture("platinum_tpu_torch").data
    opaque = cut.copy()
    opaque[..., 3] = 255
    srgb = TextureFormat.SRGB_RGBA
    assert Texture(data=cut, format=srgb).has_alpha is True
    assert Texture(data=opaque, format=srgb).has_alpha is False
    assert Texture(data=cut, format=srgb, has_alpha=False).has_alpha is False
    assert Texture(data=opaque, format=srgb, has_alpha=True).has_alpha is True
    for fmt in (TextureFormat.LINEAR_RGBA, TextureFormat.MONO,
                TextureFormat.ROUGH_METAL):
        assert Texture(data=cut, format=fmt).has_alpha is False
    hdr = np.zeros((4, 4, 4), np.float32)
    assert Texture(data=hdr, format=TextureFormat.HDR).has_alpha is False
    helmet = scenes.load_file(os.path.join(ROOT, "portbench", "generators",
                                           "helmet.py"), "test_helmet_maps_")
    for k, t in helmet.maps(16).items():
        assert Texture(data=t["data"], format=TextureFormat(t["format"]),
                       name=k).has_alpha is False, k


# ---------------------------------------------------------------------------
# Counters, rays, syncs
# ---------------------------------------------------------------------------

def test_alpha_counters_and_rays_tie_together():
    """On the cutout scene: the alpha waves are the closest-hit traces
    after each bounce's first; their queried lanes are what the rays of
    `return_stats` add to one a live lane (the shadow waves stand in for
    the any-hit wave, whose lane is not counted again); passes lie among
    the hits drawn for and the lanes out of budget among the passes."""
    scene, cam = cutout_scene("platinum_tpu_torch")
    s = RenderSettings(width=24, height=24, spp=1, max_bounces=4,
                       kernel="mis", tracer="packet", instancing="off")
    flat = flatten_scene(scene, cam, s, accel_min_tris=1, device="cpu")
    feats = analyze_features(flat)
    assert "alpha" in feats
    closest, any_hit = integrator.make_tracers(flat, s)
    queried = []

    def counted(o, d, tmin, tmax, active=None):
        queried.append(float(active.sum()))
        return closest(o, d, tmin, tmax, active=active)

    telemetry.drain()
    telemetry.start()
    try:
        _, rays = integrator.render_sample(flat, s, 3,
                                           tracers=(counted, any_hit),
                                           return_stats=True, features=feats)
        c = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
        telemetry.drain()
    per = 1 + integrator.ALPHA_HOPS + integrator.ALPHA_HOPS + 1
    assert len(queried) % per == 0 and len(queried) > per
    alpha = [q for i, q in enumerate(queried) if i % per]
    assert float(rays) == c["integrator.live_lanes"] + sum(alpha)
    assert 0 < c["integrator.alpha_passed"] < c["integrator.alpha_tested"]
    assert c["integrator.alpha_tested"] <= sum(alpha) + c[
        "integrator.live_lanes"]
    # a lane out of budget passed its last test
    assert 0 <= c["integrator.alpha_budget_out"] <= c[
        "integrator.alpha_passed"]


def test_a_street_sample_syncs_only_to_test_for_live_lanes(small,
                                                          monkeypatch):
    """The path hops and the shadow waves copy nothing from the host and
    read nothing back inside a bounce: a capture of the bounce is sound."""
    s = _settings(w=16, h=9, compact=False, compact_plan=None)
    scene, cam = harness.port_scene(small)
    flat = flatten_scene(scene, cam, s, device="cpu")
    feats = analyze_features(flat)
    assert {"alpha", "env", "area_lights", "texslot0"} <= feats
    tracers = integrator.make_tracers(flat, s)
    assert all(f.capturable for f in tracers)
    telemetry.drain()
    telemetry.start()
    try:
        seen, on = _count_blocking(monkeypatch)
        on[0] = True
        integrator.render_sample(flat, s, 5, tracers=tracers, features=feats)
        on[0] = False
        d = telemetry.drain()
    finally:
        telemetry.stop()
        telemetry.drain()
    c = d["counters"]
    syncs = {k: v for k, v in c.items() if k.startswith("sync.") and v}
    assert set(syncs) == {"sync.live_check", "sync.sample_index"}
    assert sum(syncs.values()) == sum(seen.values())
    spans = [x for x in d["spans"] if x["name"].startswith("integrator.alpha")]
    assert {x["name"] for x in spans} == {"integrator.alpha_hops",
                                          "integrator.alpha_shadow"}
