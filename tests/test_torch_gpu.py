"""The CUDA wide-BVH kernel on the card: one-level (K1, K2) and two-level
(K3) modes, the MT tiers (K4, K5), streamed blocks (K6) and the octant
order (K7) against their plain PyTorch versions and, for the modes that
compute K1's function, against K1 bit for bit; the split kernel's
pre-split planes against their plain version, and K4 against the
ray-stream tracer at its tier bit for bit; the paired launch (K8), the
pipelined walk (K9) and the ablation modes against K1/K2/K3; the
warp-wide drains of K1 and K7 closest against K15's per-pair test on
every (ray, block) pair, of K2 and K6 any hit against the per-thread
classic walk (`profile="fix64"`) in flag and per-ray counts, of K3
closest against its plain version, and of K6, K7 and K9 against K1/K3
bit for bit; K8's halves against the unpaired drains in outputs and
counts; the C entry's refusal of every walk code past 2;
the leaf-pair kernel (K15) against its plain version, its chunked
schedule against its own per-pair path bit for bit, and the ray-stream
tracer against K1/K2 bit for bit; the redesigned level prefix (K11)
against its plain version on synthetic levels; the breadth-first
pipeline's five kernels (K10-K14) against their plain versions level by
level, K10, K12 and K14 also on their corner cases, K13 against K15 on
its pairs bit for bit, and its tracer against K1/K2 bit for bit, with
its capacities forced small; the wrappers' input checks
and refusals, and the threefry draws on the card against the CPU; the
final render's bounces as captured CUDA graphs (render/graphs.py) against
the eager bounces bit for bit, counters and launches included, and their
capture again after an instance edit; the same of the alpha-cutout
bounces (the small street of portbench's bistro_exterior generator and
the checker-cut colonnade), and their hops' and shadow waves' fetches
through the hit-fetch kernel against the plain code bit for bit. Every test
here needs a CUDA device and skips without one; this module imports no
JAX and nothing of the JAX package, so it also runs where only PyTorch is
installed (`python -m pytest tests/test_torch_gpu.py -m gpu`)."""

import os
import sys

import numpy as np
import pytest
import torch

from platinum_tpu_torch.accel.bvh import build_bvh
from platinum_tpu_torch.accel.wide import build_octant_orders, build_wide_bvh
from platinum_tpu_torch.ops import bfstream as bf
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.ops import raystream as rs
from platinum_tpu_torch.ops import threefry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_kernel_cases as kc  # noqa: E402

pytestmark = pytest.mark.gpu
TMIN = 1e-3


@pytest.fixture
def soup_on_card():
    """A random triangle soup's wide BVH on the card (the recipe of
    tests/test_pallas_trace.py's `_random_soup`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    t = 800
    c = rng.uniform(-4, 4, (t, 3)).astype(np.float32)
    v0, v1, v2 = (c + rng.normal(0, 0.3, (t, 3)).astype(np.float32)
                  for _ in range(3))
    bvh = build_bvh(v0, v1, v2, max_leaf=4)
    o = bvh.tri_order
    geo = np.concatenate([v0[o], v1[o] - v0[o], v2[o] - v0[o],
                          np.zeros((t, 3), np.float32)], -1)
    wide = build_wide_bvh(bvh, geo, leaf_cap=16)
    dev = torch.device("cuda")
    return (torch.from_numpy(wide.nodes).reshape(-1, 16, 8).to(dev),
            torch.from_numpy(wide.tri_blocks).to(dev),
            torch.from_numpy(wide.meta).to(dev),
            torch.from_numpy(build_octant_orders(wide.nodes)).to(dev))


def _rays(n, tmax, dev):
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o.T, d.T, np.full((1, n), TMIN, np.float32),
                           np.full((1, n), tmax, np.float32)])
    return torch.from_numpy(rays).to(dev).contiguous()


@pytest.mark.parametrize("any_hit,tmax", [(False, np.inf), (True, 8.0)])
def test_kernel_matches_plain_version(soup_on_card, any_hit, tmax):
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(4096, tmax, nodes.device)
    before = dict(pt.LAUNCHES)
    k = pt.trace_wide(rays, nodes, blocks, meta, any_hit)
    p = pt.trace_wide_plain(rays, nodes, blocks, meta, any_hit)
    torch.cuda.synchronize()
    mode = "any" if any_hit else "closest"
    assert pt.LAUNCHES[mode] == before[mode] + 1
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100
    if not any_hit:
        both = hk & hp
        tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
        assert ((k[1][both] == p[1][both]) | tie).all()
        torch.testing.assert_close(k[0][both], p[0][both],
                                   rtol=1e-4, atol=1e-5)


def test_wrapper_refuses_bad_inputs(soup_on_card):
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(256, np.inf, nodes.device)
    with pytest.raises(TypeError):
        pt.trace_wide(rays, nodes, blocks, meta.long(), False)
    with pytest.raises(ValueError, match="contiguous"):
        pt.trace_wide(rays[:, ::2], nodes, blocks, meta, False)
    with pytest.raises(ValueError, match="is on"):
        pt.trace_wide(rays, nodes.cpu(), blocks, meta, False)


def test_empty_wave_launches_nothing(soup_on_card):
    """A wave of no rays returns empty outputs and counts no launch."""
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(256, np.inf, nodes.device)[:, :0].contiguous()
    before = dict(pt.LAUNCHES)
    for any_hit in (False, True):
        out = pt.trace_wide(rays, nodes, blocks, meta, any_hit)
        assert all(x.shape == (0,) for x in out)
    closest, occ = pt.trace_wide_paired(rays, rays, nodes, blocks, meta)
    assert occ.shape == (0,) and closest[0].shape == (0,)
    assert pt.LAUNCHES == before


@pytest.fixture
def instanced_on_card():
    """The 24-instance scene of tests/test_tlas.py, flattened two-level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from instanced_scenes import instanced_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = instanced_scene("platinum_tpu_torch")
    flat = flatten_scene(scene, cam, RenderSettings(
        width=48, height=48, instancing="on", tracer="packet"),
        accel_min_tris=1, device="cuda")
    return (flat.wbvh_nodes.reshape(-1, 16, 8).contiguous(), flat.wbvh_tris,
            flat.wbvh_meta, flat.instances.feat, flat.wbvh_order)


@pytest.mark.parametrize("any_hit,tmax", [(False, np.inf), (True, 6.0)])
def test_instanced_kernel_matches_plain_version(instanced_on_card, any_hit,
                                                tmax):
    nodes, blocks, meta, feat, _ = instanced_on_card
    rays = _rays(4096, tmax, nodes.device)
    before = dict(pt.LAUNCHES)
    k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat=feat)
    p = pt.trace_wide_inst_plain(rays, nodes, blocks, meta, any_hit, feat)
    torch.cuda.synchronize()
    mode = "inst_any" if any_hit else "inst_closest"
    assert pt.LAUNCHES[mode] == before[mode] + 1
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100
    if not any_hit:
        both = hk & hp
        same = k[1][both] == p[1][both]
        tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
        assert (same | tie).all()
        assert (k[4][both][same] == p[4][both][same]).all()
        torch.testing.assert_close(k[0][both], p[0][both],
                                   rtol=1e-4, atol=1e-5)


# "high" against its plain version: both form the same exact bf16
# products and differ at most in the order of fp32 sums, so t holds to a
# few ulps where the ids agree; against K1 its t must differ in its bits on
# >= TIER_DIFF_MIN of the common hits (bf16x3 is not fp32)
HIGH_T_RTOL = 1e-6
TIER_DIFF_MIN = 0.9


def _hold_to_plain(k, p, mode, rtol=1e-4, atol=1e-5):
    """The K1 test's bars: >= 99.5% equal hit sets, ids equal outside
    t ties, t to rtol 1e-4 / atol 1e-5 (or the given bar) where the ids
    agree."""
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100, mode
    both = hk & hp
    same = k[1][both] == p[1][both]
    tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
    assert (same | tie).all(), mode
    torch.testing.assert_close(k[0][both][same], p[0][both][same],
                               rtol=rtol, atol=atol)


def _hold_high(k, p, k1, mode):
    """K4 "high": t to HIGH_T_RTOL of its plain version, and moved off
    K1's (fp32) t on >= TIER_DIFF_MIN of the same-triangle hits."""
    _hold_to_plain(k, p, mode, rtol=HIGH_T_RTOL, atol=0.0)
    same = (k1[1] >= 0) & (k[1] == k1[1])
    moved = (k[0][same].view(torch.int32)
             != k1[0][same].view(torch.int32)).float().mean().item()
    assert same.sum() > 100 and moved >= TIER_DIFF_MIN, (mode, moved)


def _bitwise(k, ref, mode):
    """Hit set and t bit for bit; ids and instances equal (the soups here
    have no exact-t ties across blocks)."""
    hk, hr = k[1] >= 0, ref[1] >= 0
    assert torch.equal(hk, hr), mode
    assert torch.equal(k[0][hr], ref[0][hr]), mode
    for a, b in zip(k[1:], ref[1:]):
        assert torch.equal(a, b), mode


MODES = [dict(mt_precision="high"), dict(mt_precision="default"),
         dict(mt_precision="two_phase"), dict(stream=True),
         dict(oct=True), dict(oct=True, stream=True),
         dict(oct=True, mt_precision="high")]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "+".join(
    f"{k}={v}" for k, v in m.items()))
def test_variant_matches_plain_and_k1(soup_on_card, mode):
    """K4-K7 closest hit against their plain versions; K5, K6 and K7 (and
    K7 over K4) bit for bit against the mode without them."""
    nodes, blocks, meta, worder = soup_on_card
    rays = _rays(4096, np.inf, nodes.device)
    kw = dict(mode)
    oct_on = kw.pop("oct", False)
    key = pt.launch_key(False, False, kw.get("mt_precision", "highest"),
                        oct_on, kw.get("stream", False))
    if "mt_precision" in kw:
        kw["planes"] = pt.split_planes(blocks)
    before = pt.LAUNCHES[key]
    k = pt.trace_wide(rays, nodes, blocks, meta, False,
                      worder=worder if oct_on else None, **kw)
    torch.cuda.synchronize()
    assert pt.LAUNCHES[key] == before + 1
    p = pt.trace_wide_reference(rays, nodes, blocks, meta, False, **kw)
    tier = kw.get("mt_precision", "highest")
    if tier == "high":
        _hold_high(k, p, pt.trace_wide(rays, nodes, blocks, meta, False), key)
    else:
        _hold_to_plain(k, p, key)
    if tier in ("highest", "two_phase") or oct_on:
        base = pt.trace_wide(rays, nodes, blocks, meta, False,
                             mt_precision="high" if tier == "high"
                             else "highest", planes=kw.get("planes"))
        _bitwise(k, base, key)


def test_split_planes_kernel_is_its_plain_version(soup_on_card):
    """The pre-split planes from the split kernel: the plain version's
    table in every bit, one counted launch; a packet tracer at a reduced
    tier splits once, when it is made, and never per wave."""
    nodes, blocks, meta, _ = soup_on_card
    before = pt.LAUNCHES["split_planes"]
    planes = pt.split_planes(blocks)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["split_planes"] == before + 1
    assert planes.shape == (blocks.shape[0], 2, 10, 256)
    assert torch.equal(planes.view(torch.int16),
                       pt.split_planes_plain(blocks).view(torch.int16))
    tc, _ = pt.make_packet_tracer(nodes.reshape(-1, 128), blocks, meta,
                                  mt_precision="high")
    assert torch.equal(tc.planes.view(torch.int16), planes.view(torch.int16))
    rays = _rays(1024, np.inf, nodes.device)
    tc(rays[0:3].T, rays[3:6].T, TMIN, float("inf"))
    tc(rays[0:3].T, rays[3:6].T, TMIN, float("inf"))
    assert pt.LAUNCHES["split_planes"] == before + 2


@pytest.mark.parametrize("tier", ["high", "default"])
def test_reduced_tier_is_the_stream_tracer_bit_for_bit(soup_on_card, tier):
    """K4 tests blocks warp-wide over the pre-split planes, the ray-stream
    tracer's leaf-pair kernel (K15) one (ray, block) pair per thread; both
    form each triangle's t with csrc/mt_block.cuh's arithmetic, so the
    two tracers agree at the tier in every bit: hit set, t, ids and
    barycentrics (the soup has no exact-t ties across blocks)."""
    nodes, blocks, meta, _ = soup_on_card
    sc, _ = rs.make_stream_tracer(nodes.reshape(-1, 128), blocks, meta,
                                  mt_precision=tier)
    pc, _ = pt.make_packet_tracer(nodes.reshape(-1, 128), blocks, meta,
                                  mt_precision=tier)
    rays = _rays(4096, np.inf, nodes.device)
    o, d = rays[0:3].T, rays[3:6].T
    rec, ref = sc(o, d, TMIN, float("inf")), pc(o, d, TMIN, float("inf"))
    assert torch.equal(rec.hit, ref.hit) and ref.hit.sum() > 100
    assert torch.equal(rec.t.view(torch.int32), ref.t.view(torch.int32))
    assert torch.equal(rec.tri, ref.tri) and torch.equal(rec.bary, ref.bary)


def _classic_any(rays, nodes, blocks, meta):
    """The flag and the (7, R) counting table of the per-thread classic
    any-hit walk, reached through `profile="fix64"`: the whole walk where
    it ends within 64 pops, which it asserts."""
    counts = pt.trace_wide_counts(rays, nodes, blocks, meta, True,
                                  profile="fix64", per_ray=True)
    assert int(counts[0].max()) < 64
    return (pt.trace_wide(rays, nodes, blocks, meta, True,
                          profile="fix64")[1], counts)


def test_streamed_any_hit_equals_k2(soup_on_card):
    """K6 any hit, counted under its own key, is K2 in every output (both
    take the any-hit drain), and its flag is that of the per-thread
    classic walk (`profile="fix64"`) on every ray."""
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(4096, 8.0, nodes.device)
    before = pt.LAUNCHES["stream+any"]
    k = pt.trace_wide(rays, nodes, blocks, meta, True, stream=True)
    assert pt.LAUNCHES["stream+any"] == before + 1
    _bitwise(k, pt.trace_wide(rays, nodes, blocks, meta, True), "stream+any")
    assert torch.equal(k[1], _classic_any(rays, nodes, blocks, meta)[0])


@pytest.mark.parametrize("mode", [dict(mt_precision="high"),
                                  dict(mt_precision="two_phase"),
                                  dict(stream=True), dict(oct=True)],
                         ids=lambda m: "+".join(f"{k}={v}"
                                                for k, v in m.items()))
def test_instanced_variant_matches_plain_and_k3(instanced_on_card, mode):
    nodes, blocks, meta, feat, worder = instanced_on_card
    rays = _rays(4096, np.inf, nodes.device)
    kw = dict(mode)
    oct_on = kw.pop("oct", False)
    if "mt_precision" in kw:
        kw["planes"] = pt.split_planes(blocks)
    k = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat=feat,
                      worder=worder if oct_on else None, **kw)
    p = pt.trace_wide_reference(rays, nodes, blocks, meta, False, feat, **kw)
    torch.cuda.synchronize()
    if kw.get("mt_precision") == "high":
        _hold_high(k, p, pt.trace_wide(rays, nodes, blocks, meta, False,
                                       inst_feat=feat), str(mode))
    else:
        _hold_to_plain(k, p, str(mode))
    assert (k[4][(k[1] >= 0) & (k[1] == p[1])]
            == p[4][(k[1] >= 0) & (k[1] == p[1])]).all()
    if kw.get("mt_precision") != "high":
        _bitwise(k, pt.trace_wide(rays, nodes, blocks, meta, False,
                                  inst_feat=feat), str(mode))
    if kw.get("stream"):
        shadow = _rays(4096, 6.0, nodes.device)
        _bitwise(pt.trace_wide(shadow, nodes, blocks, meta, True,
                               inst_feat=feat, stream=True),
                 pt.trace_wide(shadow, nodes, blocks, meta, True,
                               inst_feat=feat), "stream+inst_any")


def test_modes_that_cannot_run_raise(soup_on_card):
    """A tier or flag the kernel cannot honour raises; it never returns
    the plain version's or another mode's results."""
    nodes, blocks, meta, worder = soup_on_card
    rays = _rays(256, np.inf, nodes.device)
    before = dict(pt.LAUNCHES)
    with pytest.raises(ValueError, match="two_phase"):
        pt.trace_wide(rays, nodes, blocks, meta, False,
                      mt_precision="two_phase", stream=True)
    with pytest.raises(ValueError, match="unknown mt_precision"):
        pt.trace_wide(rays, nodes, blocks, meta, False, mt_precision="low")
    with pytest.raises(ValueError, match="worder"):
        pt.trace_wide(rays, nodes, blocks, meta, False, worder=worder[:-16])
    for tier in ("high", "default", "two_phase"):
        with pytest.raises(ValueError, match="planes"):
            pt.trace_wide(rays, nodes, blocks, meta, False, mt_precision=tier)
        with pytest.raises(ValueError, match="planes"):
            pt.trace_wide_paired(rays, rays, nodes, blocks, meta,
                                 mt_precision=tier)
    assert pt.LAUNCHES == before
    # the C entry refuses the same combinations by itself
    lib = pt._library()
    out = torch.empty(256, device=nodes.device)
    sid = torch.empty(256, dtype=torch.int32, device=nodes.device)
    # (any_hit, tier, stream, walk, profile, n_split): an unknown tier,
    # two_phase streamed, pipe with a tier / with stream / with a profile,
    # a profile with a tier, fix64 streamed, a paired split inside a
    # block, a reduced tier's closest hit (and paired) without the planes
    # ... and every walk code past 2 (3-7), for closest, any hit and
    # paired: 4-6 were the per-thread walks' flag on 0-2
    bad = [(0, 1, 0, 0, 0, 0), (0, 2, 0, 0, 0, 0), (2, 3, 0, 0, 0, 128),
           (0, 7, 0, 0, 0, 0), (0, 3, 1, 0, 0, 0), (0, 1, 0, 1, 0, 0),
           (0, 0, 1, 1, 0, 0), (0, 0, 0, 2, 2, 0), (0, 1, 0, 0, 2, 0),
           (0, 0, 1, 0, 3, 0), (2, 0, 0, 0, 0, 100), (2, 0, 0, 1, 0, 128)]
    bad += [(a, 0, 0, w, 0, 128 if a == 2 else 0)
            for a in (0, 1, 2) for w in range(3, 8)]
    for any_hit, prec, stream, walk, prof, split in bad:
        rc = lib.wide_trace_launch(
            rays.data_ptr(), 256, split, nodes.data_ptr(), blocks.data_ptr(),
            None, meta.data_ptr(), None, None, any_hit, prec, stream, walk,
            prof,
            out.data_ptr(), sid.data_ptr(), out.data_ptr(), out.data_ptr(),
            None, None, torch.cuda.current_stream().cuda_stream)
        # cudaErrorInvalidValue
        assert rc == 1, (any_hit, prec, stream, walk, prof, split)
    with pytest.raises(ValueError, match="fp32"):
        pt.trace_wide(rays, nodes, blocks, meta, False, pipe=True,
                      mt_precision="high")
    with pytest.raises(ValueError, match="default walk"):
        pt.trace_wide(rays, nodes, blocks, meta, False, pipe=True,
                      stream=True)
    assert pt.LAUNCHES == before


@pytest.mark.parametrize("n_c,n_a", [(4096, 4096), (1000, 4096),
                                     (4096, 300), (0, 2048), (2048, 0)])
@pytest.mark.parametrize("mode", [dict(), dict(mt_precision="high"),
                                  dict(mt_precision="two_phase"),
                                  dict(stream=True),
                                  dict(mt_precision="default"),
                                  dict(mt_precision="high", stream=True),
                                  dict(mt_precision="default", stream=True)],
                         ids=lambda m: "+".join(m) or "fp32")
def test_paired_launch_is_k1_and_k2_bit_for_bit(soup_on_card, n_c, n_a, mode):
    """K8 in every mode, resident and streamed: one launch, each CTA on
    its half's unpaired drain: the closest half bit for bit the unpaired
    closest mode at the tier / stream, the any-hit half bit for bit K2;
    either wave longer, or empty. At fp32, resident and streamed,
    the counting tables of the halves are the unpaired K1 / K6 closest and
    K2 drains' row for row, drain rows included. A reduced tier reads the
    blocks' pre-split planes, split beforehand, as a tracer does once."""
    nodes, blocks, meta, _ = soup_on_card
    rc = _rays(4096, np.inf, nodes.device)[:, :n_c].contiguous()
    ra = _rays(4096, 8.0, nodes.device).flip(1)[:, :n_a].contiguous()
    key = pt.launch_key(False, paired=True, **mode)
    kw = (dict(mode, planes=pt.split_planes(blocks))
          if "mt_precision" in mode else mode)
    stream = mode.get("stream", False)
    ref_c = pt.trace_wide(rc, nodes, blocks, meta, False, **kw)
    ref_a = pt.trace_wide(ra, nodes, blocks, meta, True, **kw)
    before = dict(pt.LAUNCHES)
    closest, occ = pt.trace_wide_paired(rc, ra, nodes, blocks, meta, **kw)
    torch.cuda.synchronize()
    after = dict(pt.LAUNCHES)
    assert after.pop(key) == before.pop(key) + 1 and after == before
    for a, b in zip(closest, ref_c, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(occ, ref_a[1])
    if "mt_precision" not in mode:
        cc, ca = pt.trace_wide_paired_counts(rc, ra, nodes, blocks, meta,
                                             stream=stream, per_ray=True)
        assert torch.equal(cc, pt.trace_wide_counts(
            rc, nodes, blocks, meta, False, stream=stream, per_ray=True))
        assert torch.equal(ca, pt.trace_wide_counts(
            ra, nodes, blocks, meta, True, stream=stream, per_ray=True))
    if n_c == n_a:
        assert (closest[1] >= 0).sum() > 100 and (occ > 0).sum() > 100


def test_paired_tracer_entry_on_the_card(soup_on_card):
    nodes, blocks, meta, _ = soup_on_card
    tc, ta = pt.make_packet_tracer(nodes.reshape(-1, 128), blocks, meta,
                                   sort=True)
    rc, ra = _rays(4096, np.inf, nodes.device), _rays(3000, 8.0, nodes.device)
    oc, dc, oa, da = rc[0:3].T, rc[3:6].T, ra[0:3].T.flip(0), ra[3:6].T
    before = pt.LAUNCHES["paired"]
    rec, occ = tc.paired(oc, dc, TMIN, float("inf"), oa, da, TMIN, 8.0)
    assert pt.LAUNCHES["paired"] == before + 1
    ref = tc(oc, dc, TMIN, float("inf"))
    assert torch.equal(rec.t, ref.t) and torch.equal(rec.tri, ref.tri)
    assert torch.equal(occ, ta(oa, da, TMIN, 8.0))


@pytest.mark.parametrize("walk", ["pipe", "flat_walk"])
def test_pipelined_walk_is_k1_and_k2_bit_for_bit(soup_on_card, walk):
    """K9 on one tree: hit set, t, ids and barycentrics of K1 / K2, and
    its plain version (K1's) to K1's bars."""
    nodes, blocks, meta, _ = soup_on_card
    for any_hit, tmax in ((False, np.inf), (True, 8.0)):
        rays = _rays(4096, tmax, nodes.device)
        key = pt.launch_key(any_hit, pipe=True, flat_walk=walk == "flat_walk")
        before = pt.LAUNCHES[key]
        k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, **{walk: True})
        assert pt.LAUNCHES[key] == before + 1
        _bitwise(k, pt.trace_wide(rays, nodes, blocks, meta, any_hit), key)
        if not any_hit:
            _hold_to_plain(k, pt.trace_wide_reference(
                rays, nodes, blocks, meta, False, **{walk: True}), key)
        counts = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                      **{walk: True})
        assert counts["pops"] > 0 and counts["mt_tests"] > 0


def test_fp32_closest_hit_drains_warp_wide(soup_on_card):
    """K1 and K6 closest take the warp-wide drain over the fp32 blocks: on
    a wave of 4,001 rays (not a multiple of 32), every fifth one dead
    (tmax below tmin), the hit set and t are those of K15's per-pair test
    on every (ray, block) pair in every bit, the ids, u and v too outside
    exact-t ties between blocks; K6 and K9 (`pipe=True`) give K1's every
    output in every bit, and the counting instantiation fills the drain
    rows (0 < rounds <= distinct blocks <= MT tests), the same for K1 and
    K6."""
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(4001, np.inf, nodes.device)
    rays[7, ::5] = rays[6, ::5] - 1.0
    k1 = pt.trace_wide(rays, nodes, blocks, meta, False)
    for kw in (dict(stream=True), dict(pipe=True)):
        _same_bits(pt.trace_wide(rays, nodes, blocks, meta, False, **kw), k1,
                   str(kw))
    hit = k1[1] >= 0
    assert not hit[::5].any() and hit.sum() > 300
    ref = kc.brute_closest(rs.stream_mt, rays, blocks, "highest")
    assert torch.equal(ref[1] >= 0, hit)
    _same_bits((k1[0][hit],), (ref[0][hit],), "t")
    keep = hit & ~ref[4]
    assert keep.sum() > 300
    _same_bits([x[keep] for x in k1[1:]], [x[keep] for x in ref[1:4]], "ids")
    c1, c6 = (pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                                   stream=stream) for stream in (False, True))
    assert c1 == c6
    assert 0 < c1["drain_rounds"] <= c1["distinct_blocks"] <= c1["mt_tests"]


def test_instanced_fp32_closest_hit_drains_warp_wide(instanced_on_card):
    """K3 closest and its streamed mode take the warp-wide drain over the
    fp32 blocks: on a 4,001-ray wave with every fifth ray dead, K3 is held
    to its plain version (the K1 test's bars, instance ids equal where the
    ids agree) and K6 and K9 (`pipe=True`) give its every output, the
    instance id included, bit for bit; each launch is counted under its
    own key, and the counting instantiation enters instances and fills
    the drain rows, the same for both."""
    nodes, blocks, meta, feat, _ = instanced_on_card
    rays = _rays(4001, np.inf, nodes.device)
    rays[7, ::5] = rays[6, ::5] - 1.0
    k3 = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat=feat)
    for kw in (dict(stream=True), dict(pipe=True)):
        key = pt.launch_key(False, True, **kw)
        before = pt.LAUNCHES[key]
        k = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat=feat,
                          **kw)
        assert pt.LAUNCHES[key] == before + 1
        _same_bits(k, k3, key)
    hit = k3[1] >= 0
    assert not hit[::5].any() and hit.sum() > 100
    p = pt.trace_wide_inst_plain(rays, nodes, blocks, meta, False, feat)
    _hold_to_plain(k3, p, "inst_closest")
    same = hit & (k3[1] == p[1])
    assert torch.equal(k3[4][same], p[4][same])
    c3, c6 = (pt.trace_wide_counts(rays, nodes, blocks, meta, False, feat,
                                   stream=stream) for stream in (False, True))
    assert c3 == c6 and c3["inst_entries"] > 0
    assert 0 < c3["drain_rounds"] <= c3["distinct_blocks"] <= c3["mt_tests"]


def test_streamed_any_hit_drains_warp_wide(soup_on_card):
    """K2 and K6 any hit take the warp-wide any-hit drain, one counted
    launch a wave each: on a 4,001-ray shadow wave with every fifth ray
    dead their flag is that of the per-thread classic walk
    (`profile="fix64"`, where every walk ends within 64 pops) on every
    ray, t is tmax and u, v are 0; per ray they pop that walk's nodes and
    test its blocks; the drain rows are filled, the same for both."""
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(4001, 8.0, nodes.device)
    rays[7, ::5] = rays[6, ::5] - 1.0
    occ, cref = _classic_any(rays, nodes, blocks, meta)
    for stream in (False, True):
        key = pt.launch_key(True, stream=stream)
        before = pt.LAUNCHES[key]
        k = pt.trace_wide(rays, nodes, blocks, meta, True, stream=stream)
        assert pt.LAUNCHES[key] == before + 1
        assert torch.equal(k[1], occ), key
        assert torch.equal(k[0].view(torch.int32), rays[7].view(torch.int32))
        assert not k[2].any() and not k[3].any()
    assert not (occ[::5] > 0).any() and (occ > 0).sum() > 300
    c2, c6 = (pt.trace_wide_counts(rays, nodes, blocks, meta, True,
                                   stream=stream, per_ray=True)
              for stream in (False, True))
    assert torch.equal(c2, c6) and torch.equal(c2[:2], cref[:2])
    assert not c2[2:5].any() and not cref[2:].any()
    rounds, distinct = int(c2[5].sum()), int(c2[6].sum())
    assert 0 < rounds <= distinct <= int(c2[1].sum())


def test_instanced_any_hit_drains_warp_wide(instanced_on_card):
    """The instanced any hit and its streamed mode take the warp-wide
    any-hit drain with the ten-lane instance entry, one counted launch a
    wave each: on a 4,001-ray shadow wave with every fifth ray dead every
    output is K9 any hit's (`pipe=True`) bit for bit, the flag agrees with
    the plain version's on >= 99.5% of rays; the counting instantiation
    enters instances and fills the drain rows, the same for both, and on
    every ray that nothing occludes pops K9's nodes and tests its
    blocks."""
    nodes, blocks, meta, feat, _ = instanced_on_card
    rays = _rays(4001, 6.0, nodes.device)
    rays[7, ::5] = rays[6, ::5] - 1.0
    pipe = pt.trace_wide(rays, nodes, blocks, meta, True, inst_feat=feat,
                         pipe=True)
    for stream in (False, True):
        key = pt.launch_key(True, True, stream=stream)
        before = pt.LAUNCHES[key]
        k = pt.trace_wide(rays, nodes, blocks, meta, True, inst_feat=feat,
                          stream=stream)
        assert pt.LAUNCHES[key] == before + 1
        _bitwise(k, pipe, key)
    occ = pipe[1] > 0
    assert not occ[::5].any() and occ.sum() > 100 and (~occ).sum() > 100
    p = pt.trace_wide_inst_plain(rays, nodes, blocks, meta, True, feat)
    assert (k[1] == p[1]).float().mean() > 0.995
    c3, c6, c9 = (pt.trace_wide_counts(rays, nodes, blocks, meta, True, feat,
                                       per_ray=True, **kw)
                  for kw in (dict(), dict(stream=True), dict(pipe=True)))
    assert torch.equal(c3, c6) and int(c3[2].sum()) > 0
    assert 0 < int(c3[5].sum()) <= int(c3[6].sum()) <= int(c3[1].sum())
    assert torch.equal(c3[:2, ~occ], c9[:2, ~occ])


def _same_bits(k, ref, mode):
    """Every output equal in every bit, misses included."""
    assert len(k) == len(ref), mode
    for a, b in zip(k, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), mode


def _drained(rays, nodes, blocks, meta, any_hit, kw, key, inst):
    """One counted launch of a drained mode under its launch key, the
    drain rows of its counting instantiation filled, no refine test or
    re-walk, instance entries on an instanced tree. Returns the
    outputs."""
    before = dict(pt.LAUNCHES)
    k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, **kw)
    after = dict(pt.LAUNCHES)
    assert after.pop(key) == before.pop(key) + 1 and after == before, key
    c = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                             per_ray=True, **kw)
    assert not c[3:5].any(), key
    assert 0 < int(c[5].sum()) <= int(c[6].sum()) <= int(c[1].sum()), key
    assert (int(c[2].sum()) > 0) == inst, key
    return k


@pytest.mark.parametrize("tree", ["soup", "instanced"])
def test_oct_order_closest_hit_drains_warp_wide(soup_on_card,
                                                instanced_on_card, tree):
    """K7, fp32 closest hit under the octant order, resident and streamed,
    takes the fp32 drain with each lane's queue drained newest first: on a
    4,001-ray wave with every fifth ray dead, one counted launch under its
    key; its hit set and t are K1's / K3's in every bit, and so is every
    output (the instance id included) wherever the ids agree (elsewhere
    two blocks tie at t); on one level its hit set and t are also K15's
    per-pair test's on every (ray, block) pair, its ids too outside ties."""
    if tree == "soup":
        (nodes, blocks, meta, worder), feat = soup_on_card, None
    else:
        nodes, blocks, meta, feat, worder = instanced_on_card
    rays = _rays(4001, np.inf, nodes.device)
    rays[7, ::5] = rays[6, ::5] - 1.0
    k1 = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat=feat)
    ref = (kc.brute_closest(rs.stream_mt, rays, blocks, "highest")
           if feat is None else None)
    for stream in (False, True):
        key = pt.launch_key(False, feat is not None, oct_order=True,
                            stream=stream)
        k = _drained(rays, nodes, blocks, meta, False,
                     dict(inst_feat=feat, worder=worder, stream=stream), key,
                     feat is not None)
        hit = k[1] >= 0
        assert not hit[::5].any() and hit.sum() > 100
        assert torch.equal(hit, k1[1] >= 0)
        _same_bits((k[0],), (k1[0],), key)
        same = k[1] == k1[1]
        assert same.float().mean() > 0.99, key
        _same_bits([x[same] for x in k], [x[same] for x in k1], key)
        if ref is not None:
            keep = hit & ~ref[4]
            _same_bits((k[0][hit],), (ref[0][hit],), key)
            assert torch.equal(k[1][keep], ref[1][keep]), key


@pytest.mark.parametrize("tree", ["soup", "instanced"])
@pytest.mark.parametrize("walk", ["pipe", "flat_walk"])
def test_pipelined_walk_drains_warp_wide(soup_on_card, instanced_on_card,
                                         walk, tree):
    """K9, closest and any hit, with and without the flat push, takes the
    pipelined drain: on 4,001-ray waves with every fifth ray dead, one
    counted launch under its key, every output bit for bit K1's / K2's
    (K3's on the instanced tree), and the drain rows filled."""
    if tree == "soup":
        (nodes, blocks, meta, _), feat = soup_on_card, None
    else:
        nodes, blocks, meta, feat, _ = instanced_on_card
    if walk == "flat_walk" and not pt._single_block_leaves(meta):
        with pytest.raises(ValueError, match="exactly one MT block"):
            pt.trace_wide(_rays(64, np.inf, nodes.device), nodes, blocks,
                          meta, False, inst_feat=feat, flat_walk=True)
        return
    for any_hit, tmax in ((False, np.inf), (True, 8.0 if feat is None else 6.0)):
        rays = _rays(4001, tmax, nodes.device)
        rays[7, ::5] = rays[6, ::5] - 1.0
        key = pt.launch_key(any_hit, feat is not None, pipe=True,
                            flat_walk=walk == "flat_walk")
        k = _drained(rays, nodes, blocks, meta, any_hit,
                     dict(inst_feat=feat, **{walk: True}), key,
                     feat is not None)
        _same_bits(k, pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                                    inst_feat=feat), key)
        hit = k[1] > 0 if any_hit else k[1] >= 0
        assert not hit[::5].any() and hit.sum() > 100, key


@pytest.mark.parametrize("walk", ["pipe", "flat_walk"])
def test_instanced_pipelined_walk_is_k3_bit_for_bit(instanced_on_card, walk):
    nodes, blocks, meta, feat, _ = instanced_on_card
    if walk == "flat_walk" and not pt._single_block_leaves(meta):
        with pytest.raises(ValueError, match="exactly one MT block"):
            pt.trace_wide(_rays(64, np.inf, nodes.device), nodes, blocks,
                          meta, False, inst_feat=feat, flat_walk=True)
        return
    for any_hit, tmax in ((False, np.inf), (True, 6.0)):
        rays = _rays(4096, tmax, nodes.device)
        k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat=feat,
                          **{walk: True})
        _bitwise(k, pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                                  inst_feat=feat), f"inst {walk} {any_hit}")


def test_pipelined_walk_loses_no_block_of_an_overfull_node(soup_on_card):
    """One root whose 16 leaves own 24 blocks each: 384 against a backlog
    of 256 (no tree of accel.wide holds more than 64 under a node). What
    does not fit is tested at once: K1 / K2 bit for bit, and the drain's
    own counts show every block tested."""
    _, blocks, _, _ = soup_on_card
    dev = blocks.device
    step = (blocks.shape[0] - 24) // 15      # overlapping 24-block ranges
    assert step >= 1
    blocks = blocks[:15 * step + 24].contiguous()
    nodes = torch.zeros((1, 16, 8), device=dev)
    nodes[0, :, 0:3], nodes[0, :, 3:6] = -100.0, 100.0
    meta = -(torch.arange(16, dtype=torch.int32, device=dev) * step * 32
             + 24) - 2
    for any_hit, tmax in ((False, np.inf), (True, 8.0)):
        rays = _rays(4096, tmax, dev)
        k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, pipe=True)
        ref = pt.trace_wide(rays, nodes, blocks, meta, any_hit)
        for a, b in zip(k, ref):
            assert torch.equal(a, b)
        assert (ref[1] >= 0).sum() > 100
    tests = pt.trace_wide_counts(_rays(4096, np.inf, dev), nodes, blocks,
                                 meta, False, pipe=True, per_ray=True)[1]
    assert int(tests.max()) == 384


def test_profile_modes_do_what_they_must(soup_on_card):
    """ "empty" and "nomt" miss everything; "nomt" pops no fewer nodes
    than the per-thread walk and tests no block; "count" is K1 with u =
    the per-thread walk's pops; "fix64" runs, and counts that walk (K1's
    MT block tests; K1's warp-wide walk pops no fewer nodes) where it ends
    within 64 pops."""
    nodes, blocks, meta, _ = soup_on_card
    rays = _rays(4096, np.inf, nodes.device)
    shadow = _rays(4096, 8.0, nodes.device)
    k1 = pt.trace_wide(rays, nodes, blocks, meta, False)
    k1c = pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                               per_ray=True)
    c = pt.trace_wide(rays, nodes, blocks, meta, False, profile="count")
    pops = c[2].int()
    for prof in ("empty", "nomt"):
        for any_hit, wave in ((False, rays), (True, shadow)):
            for stream in (False, True):
                key = pt.launch_key(any_hit, stream=stream, profile=prof)
                before = pt.LAUNCHES[key]
                k = pt.trace_wide(wave, nodes, blocks, meta, any_hit,
                                  stream=stream, profile=prof)
                assert pt.LAUNCHES[key] == before + 1
                p = pt.trace_wide_reference(wave, nodes, blocks, meta,
                                            any_hit, profile=prof)
                for a, b in zip(k, p):
                    assert torch.equal(a, b), key
                assert (k[1] == -1).all()
    nomt = pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                                profile="nomt")
    assert nomt["mt_tests"] == 0 and nomt["pops"] >= int(pops.sum())
    assert torch.equal(c[0], k1[0]) and torch.equal(c[1], k1[1])
    assert torch.equal(c[3], k1[3])
    assert (pops > 0).all() and (k1c[0] >= pops).all()
    f = pt.trace_wide(rays, nodes, blocks, meta, False, profile="fix64")
    torch.cuda.synchronize()
    assert f[0].shape == k1[0].shape
    short = pops <= 64
    for x, y in zip(f, k1):
        assert torch.equal(x[short], y[short])
    fc = pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                              profile="fix64", per_ray=True)
    assert torch.equal(fc[0][short], pops[short])
    assert torch.equal(fc[1:5][:, short], k1c[1:5][:, short])
    assert (fc[0] <= 64).all() and (fc[1][~short] <= k1c[1][~short]).all()
    with pytest.raises(RuntimeError, match="launch failed"):
        pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                             profile="count")


def _level_pairs(tracer_args, rays, any_hit, tmax):
    calls = []

    def capture(*args):
        calls.append(args[:4])
        return rs.stream_mt(*args)

    pair = rs.make_stream_tracer(*tracer_args, mt_fn=capture)
    pair[int(any_hit)](rays[0:3].T, rays[3:6].T, TMIN, tmax)
    return calls


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_stream_mt_kernel_matches_plain_version(soup_on_card, tier):
    """K15 on every level's real pairs, closest and any hit: slots equal
    outside t ties, t to the tier's bar (a few ulps at "high": the same
    exact bf16 products), flags equal on >= 99.5%."""
    nodes, blocks, meta, _ = soup_on_card
    args = (nodes.reshape(-1, 128), blocks, meta)
    for any_hit, tmax in ((False, float("inf")), (True, 8.0)):
        rays = _rays(4096, tmax, nodes.device)
        key = rs.launch_key(any_hit, tier)
        for wave, limit, pair_ray, pair_block in _level_pairs(
                args, rays, any_hit, tmax):
            before = rs.LAUNCHES[key]
            k = rs.stream_mt(wave, limit, pair_ray, pair_block, blocks,
                             any_hit, tier)
            assert rs.LAUNCHES[key] == before + 1
            p = rs.stream_mt_plain(wave, limit, pair_ray, pair_block, blocks,
                                   any_hit, tier)
            hk, hp = k[1] >= 0, p[1] >= 0
            assert (hk == hp).float().mean() > 0.995
            if any_hit:
                continue
            both = hk & hp
            same = k[1][both] == p[1][both]
            tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
            assert (same | tie).all()
            rtol, atol = (HIGH_T_RTOL, 0.0) if tier == "high" else (1e-4, 1e-5)
            torch.testing.assert_close(k[0][both][same], p[0][both][same],
                                       rtol=rtol, atol=atol)


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_chunked_stream_mt_is_its_single_pair_path(soup_on_card, tier):
    """The chunked K15 on the card against itself on the same pairs with
    every pair in a run of its own (a padding pair after each), so that
    every chunk tests each pair alone (its per-pair code): t, slot, u and
    v in every bit, on every level's real pairs and on the largest level's
    pairs rearranged (tests/torch_kernel_cases.py) into runs longer than a
    chunk, runs of one pair, one block for all and a wave with dead pairs
    (block -1, ids out of range); one counted launch per call."""
    nodes, blocks, meta, _ = soup_on_card
    args = (nodes.reshape(-1, 128), blocks, meta)
    for any_hit, tmax in ((False, float("inf")), (True, 8.0)):
        rays = _rays(4096, tmax, nodes.device)
        key = rs.launch_key(any_hit, tier)
        calls = _level_pairs(args, rays, any_hit, tmax)
        wave, limit, pair_ray, pair_block = max(
            calls, key=lambda c: c[2].shape[0])
        lists = [c[2:] for c in calls] + [
            (r.to(wave.device), b.to(wave.device)) for r, b in
            kc.pair_cases(pair_ray, pair_block, wave.shape[1],
                          blocks.shape[0]).values()]
        for pr, pb in lists:
            ray1, block1 = kc.one_pair_runs(pr, pb, blocks.shape[0])
            assert not kc.chunks_staged(block1).any()
            before = rs.LAUNCHES[key]
            k = rs.stream_mt(wave, limit, pr, pb, blocks, any_hit, tier)
            torch.cuda.synchronize()
            assert rs.LAUNCHES[key] == before + 1
            p = rs.stream_mt(wave, limit, ray1, block1, blocks, any_hit, tier)
            assert (p[1][1::2] == -1).all()
            assert all(_bits(a, b[0::2]) for a, b in zip(k, p))
        assert (k[1] >= 0).sum() > 100


@pytest.mark.parametrize("case", kc.PREFIX_CASES)
def test_level_prefix_is_its_plain_version(case):
    """The redesigned K11 (scan block, then the fill grid) on the card
    against bf_prefix_plain on synthetic levels: 5,000 units of 1,300
    distinct nodes, the same overflowing both capacities, an empty level,
    regions of exactly 128 lanes; every table, tail lane and status word
    bitwise; one counted launch of the scan and of the fill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lv = kc.prefix_level(case)
    got = kc.prefix_buffers(lv, "cuda")
    ref = kc.prefix_buffers(lv, "cuda")
    before = (bf.LAUNCHES["prefix"], bf.LAUNCHES["prefix fill"])
    k = bf.bf_prefix(*kc.prefix_args(lv, got, "cuda"))
    torch.cuda.synchronize()
    assert (bf.LAUNCHES["prefix"], bf.LAUNCHES["prefix fill"]) == (
        before[0] + 1, before[1] + 1)
    p = bf.bf_prefix_plain(*kc.prefix_args(lv, ref, "cuda"))
    assert kc.same_prefix(k, got, p, ref, int(lv["level"][0])) == []
    assert (int(got[3][bf.LOST]) > 0) == (case == "overflow")


def test_stream_tracer_is_k1_and_k2_bit_for_bit(soup_on_card):
    """The ray-stream tracer on the card against the packet tracer: hit
    set and t bit for bit, ids equal (the soup has no exact-t ties
    across blocks), occlusion equal."""
    nodes, blocks, meta, _ = soup_on_card
    sc, sa = rs.make_stream_tracer(nodes.reshape(-1, 128), blocks, meta)
    pc, pa = pt.make_packet_tracer(nodes.reshape(-1, 128), blocks, meta)
    rays = _rays(4096, np.inf, nodes.device)
    o, d = rays[0:3].T, rays[3:6].T
    rec, ref = sc(o, d, TMIN, float("inf")), pc(o, d, TMIN, float("inf"))
    assert torch.equal(rec.hit, ref.hit) and ref.hit.sum() > 100
    assert torch.equal(rec.t.view(torch.int32), ref.t.view(torch.int32))
    assert torch.equal(rec.tri, ref.tri) and torch.equal(rec.bary, ref.bary)
    assert torch.equal(sa(o, d, TMIN, 8.0), pa(o, d, TMIN, 8.0))
    with pytest.raises(TypeError):
        rs.stream_mt(rays, rays[7].contiguous(),
                     torch.zeros(4, dtype=torch.int64, device=nodes.device),
                     torch.zeros(4, dtype=torch.int32, device=nodes.device),
                     blocks, False)


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _hold_bf_segment(seg, nodes, meta, blocks, any_hit, tier):
    """Every kernel of one traced segment against its plain version on
    the same inputs, on the card: all integer outputs, and K13's and
    K14's results, in every bit (the plain versions sum in the kernels'
    order). Each wrapper call launches and counts once."""
    rays, stat, levels = seg["rays"], seg["stat"].cuda(), seg["levels"]
    mtr = levels[-1]
    mt_cap = mtr["mt_units"].shape[0]
    dev = rays.device
    for lvl, lv in enumerate(levels[:-1]):
        n = int(stat[lvl, bf.NEXT])
        args = (lv["units"], stat[lvl], lv["pairs"], rays, nodes)
        before = bf.LAUNCHES["expand"]
        got = bf.bf_expand(*args)
        assert bf.LAUNCHES["expand"] == before + 1
        ref = bf.bf_expand_plain(*args)
        assert all(torch.equal(a[:n], b[:n]) for a, b in zip(got, ref))
        outs = []
        for prefix, emit in ((bf.bf_prefix, bf.bf_emit),
                             (bf.bf_prefix_plain, bf.bf_emit_plain)):
            bufs = [torch.full((max(lv["cap_next"], 1) * 128,), -2,
                               dtype=torch.int32, device=dev),
                    torch.full((mt_cap * 128,), -2, dtype=torch.int32,
                               device=dev),
                    torch.full((mt_cap,), -2, dtype=torch.int32, device=dev),
                    torch.zeros(8, dtype=torch.int32, device=dev)]
            dn, base, uoff, units_next = prefix(
                lv["units"], stat[lvl], lv["counts"], meta, lv["cap_next"],
                mt_cap, bufs[0], bufs[1], bufs[2], bufs[3])
            emit(lv["pairs"], lv["masks"], stat[lvl], dn, uoff, base,
                 bufs[0], bufs[1])
            outs.append((dn[:n], uoff[:n], units_next, base, bufs))
        (dk, uk, nk, bk, fk), (dp, up, np_, bp, fp) = outs
        nd, nn = int(fk[3][bf.DISTINCT]), int(fk[3][bf.NEXT])
        assert torch.equal(dk, dp) and torch.equal(uk, up)
        assert torch.equal(bk[:nd * 16], bp[:nd * 16])
        assert torch.equal(nk[:nn], np_[:nn])
        assert all(torch.equal(a, b) for a, b in zip(fk, fp))
        assert torch.equal(fk[3], stat[lvl + 1])
    n_mt = int(stat[-1, bf.MT_CUR])
    args = (mtr["mt_pairs"], mtr["mt_units"], stat[-1], rays, blocks,
            any_hit, tier)
    got, ref = bf.bf_mt(*args), bf.bf_mt_plain(*args)
    k = n_mt * 128
    assert all(_bits(a[:k], b[:k]) for a, b in zip(got, ref))
    res_k = res_p = None
    for lvl in range(len(levels) - 2, -1, -1):
        lv = levels[lvl]
        n = int(stat[lvl, bf.NEXT]) * 128
        a = (lv["masks"], stat[lvl], lv["dn"], lv["uoff"], lv["base"])
        res_k = bf.bf_bwd(*a, res_k, got)
        res_p = bf.bf_bwd_plain(*a, res_p, ref)
        assert all(_bits(x[:n], y[:n]) for x, y in zip(res_k, res_p))
    return n_mt


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_bf_kernels_match_plain_versions(soup_on_card, tier):
    """K10-K14 on every level of a 4,096-ray wave in two segments,
    closest and any hit, against their plain versions on the same
    inputs, bit for bit."""
    nodes, blocks, meta, _ = soup_on_card
    tc, ta = bf.make_bf_tracer(nodes.reshape(-1, 128), blocks, meta,
                               mt_precision=tier, seg_rays=2048)
    for trace, tmax in ((tc, float("inf")), (ta, 8.0)):
        rays = _rays(4096, tmax, nodes.device)
        _, segs = trace.with_levels(rays[0:3].T, rays[3:6].T, TMIN, tmax)
        assert len(segs) == 2
        for seg in segs:
            assert _hold_bf_segment(seg, nodes, meta, blocks, trace is ta,
                                    tier) > 0


def test_bf_tracer_is_k1_and_k2_bit_for_bit(soup_on_card):
    """The breadth-first tracer on the card against the packet tracer:
    hit set, t, ids and barycentrics bit for bit (the soup has no exact-t
    ties across blocks), its own any-hit mode equal to K2; the kernels of
    a wave are launched depth + 1 times each and K13 once."""
    nodes, blocks, meta, _ = soup_on_card
    wn = nodes.reshape(-1, 128)
    tc, ta = bf.make_bf_tracer(wn, blocks, meta)
    pc, pa = pt.make_packet_tracer(wn, blocks, meta)
    rays = _rays(4096, np.inf, nodes.device)
    o, d = rays[0:3].T, rays[3:6].T
    before = dict(bf.LAUNCHES)
    rec, segs = tc.with_levels(o, d, TMIN, float("inf"))
    levels = segs[0]["stat"].shape[0] - 1
    ran = {k: v - before[k] for k, v in bf.LAUNCHES.items() if v != before[k]}
    assert ran == {"expand": levels, "prefix": levels, "prefix fill": levels,
                   "emit": levels, "bwd": levels, "mt closest": 1}
    ref = pc(o, d, TMIN, float("inf"))
    assert torch.equal(rec.hit, ref.hit) and ref.hit.sum() > 100
    assert _bits(rec.t, ref.t) and torch.equal(rec.tri, ref.tri)
    assert _bits(rec.bary, ref.bary)
    assert torch.equal(ta(o, d, TMIN, 8.0), pa(o, d, TMIN, 8.0))
    act = torch.arange(4096, device=nodes.device) % 3 != 0
    occ = ta(o, d, TMIN, 8.0, active=act)
    assert torch.equal(occ, pa(o, d, TMIN, 8.0, active=act))
    assert not occ[~act].any()


def _real_lists(soup_on_card):
    """The soup's first segment of a closest and an any-hit wave of 4,096
    rays (dead tail lanes, part-live tiles), per mode."""
    nodes, blocks, meta, _ = soup_on_card
    out = {}
    for any_hit, tmax in ((False, float("inf")), (True, 8.0)):
        trace = bf.make_bf_tracer(nodes.reshape(-1, 128), blocks, meta,
                                  seg_rays=2048)[int(any_hit)]
        rays = _rays(4096, tmax, nodes.device)
        _, segs = trace.with_levels(rays[0:3].T, rays[3:6].T, TMIN, tmax)
        out[any_hit] = segs[0]
    return out


SENTINEL = -7


def _filled(kernel, dev, n_lanes, *args):
    """bf_stream.cu's entry `bf_<kernel>_launch(*args, t, sid, u, v)`
    (uncounted) into outputs filled with SENTINEL."""
    out = (torch.full((n_lanes,), float(SENTINEL), device=dev),
           torch.full((n_lanes,), SENTINEL, dtype=torch.int32, device=dev),
           torch.full((n_lanes,), float(SENTINEL), device=dev),
           torch.full((n_lanes,), float(SENTINEL), device=dev))
    bf._launch(kernel, dev, *args, *out)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_bf_mt_is_k15(soup_on_card, tier):
    """The redesigned K13 against K15 on the card (both run
    mt_chunk.cuh's task test): t, slot id, u and v in every bit over the
    tiles below the count, K15 given the same (ray, block) pairs and each
    ray's tmax as its limit: the real MT lists of a closest and an any-hit
    wave and their corner cases (tests/torch_kernel_cases.py: full tiles,
    1, 2 and 33 live lanes, a region of one block, alternating blocks,
    dead lanes and block ids out of range, exact-t twins); one counted
    launch per call, and nothing written past the count."""
    nodes, blocks, meta, _ = soup_on_card
    dev = nodes.device
    for any_hit, seg in _real_lists(soup_on_card).items():
        rec, rays = seg["levels"][-1], seg["rays"]
        n = int(seg["stat"][-1, bf.MT_CUR])
        key = bf.launch_key("mt", any_hit, tier)
        cases = kc.mt_cases(rec["mt_pairs"], rec["mt_units"], n,
                            rays.shape[1], blocks.shape[0])
        for name, (pairs, units, count) in cases.items():
            blk = kc.tied_blocks(blocks) if name == "tied" else blocks
            level = torch.zeros(8, dtype=torch.int32, device=dev)
            level[bf.MT_CUR] = count
            args = (pairs.to(dev), units.to(dev), level, rays, blk, any_hit,
                    tier)
            before = bf.LAUNCHES[key]
            k = bf.bf_mt(*args)
            torch.cuda.synchronize()
            assert bf.LAUNCHES[key] == before + 1
            p = kc.k15_of_tiles(rs.stream_mt, args[0], args[1], count, rays,
                                blk, any_hit, tier)
            lanes = count * 128
            assert all(_bits(a[:lanes], b) for a, b in zip(k, p)), name
            assert (k[1][:lanes] >= 0).sum() > 0
        cap = units.shape[0]
        got = _filled("mt", dev, cap * 128, args[0], args[1], level, cap,
                      rays, rays.shape[1], blocks, blocks.shape[0],
                      int(any_hit), pt.PRECISIONS[tier])
        assert (got[1][lanes:] == SENTINEL).all()
        assert (got[1][:lanes] != SENTINEL).all()


def test_bf_bwd_is_its_plain_version(soup_on_card):
    """The redesigned K14 against bf_bwd_plain on the card, every output
    bit: every level of a closest and an any-hit wave, deepest first, and
    a synthetic level (every child selected, none, inner and MT children
    mixed, equal t under different slot ids); one counted launch per
    call, and nothing written past the count."""
    dev = soup_on_card[0].device
    steps = []
    for seg in _real_lists(soup_on_card).values():
        levels, stat = seg["levels"], seg["stat"].to(dev)
        mt, child = levels[-1]["mt"], None
        for lvl in range(len(levels) - 2, -1, -1):
            rec = levels[lvl]
            args = (rec["masks"], stat[lvl], rec["dn"], rec["uoff"],
                    rec["base"])
            steps.append((*args, child, mt))
            child = bf.bf_bwd_plain(*args, child, mt)
    lv = kc.bwd_level()
    cuda = lambda x: tuple(y.to(dev) for y in x)
    synthetic = (*cuda((lv["masks"], lv["level"], lv["dn"], lv["uoff"],
                        lv["base"])), cuda(lv["child"]), cuda(lv["mt"]))
    steps.append(synthetic)
    for step in steps:
        n = int(step[1][bf.NEXT]) * 128
        before = bf.LAUNCHES["bwd"]
        k = bf.bf_bwd(*step)
        torch.cuda.synchronize()
        assert bf.LAUNCHES["bwd"] == before + 1
        ref = bf.bf_bwd_plain(*step)
        assert all(_bits(a[:n], b[:n]) for a, b in zip(k, ref))
    masks, level, dn, uoff, base, child, mt = synthetic
    cap, n = masks.shape[0], int(level[bf.NEXT]) * 128
    got = _filled("bwd", dev, cap * 128, masks, level, cap, dn, uoff, base,
                  *child, *mt)
    assert (got[1][n:] == SENTINEL).all() and (got[1][:n] != SENTINEL).all()


def _synthetic(make, cases, keys, dev):
    """Each case of a tests/torch_kernel_cases.py level builder on `dev`,
    "full" / "both_lists" also at the size where warps take several
    units each."""
    out = []
    for case in cases:
        for big in ((False, True) if case in ("full", "both_lists")
                    else (False,)):
            lv = make(case, big=big)
            out.append(tuple(lv[k].to(dev) if isinstance(lv[k], torch.Tensor)
                             else lv[k] for k in keys))
    return out


def test_bf_expand_is_its_plain_version(soup_on_card):
    """The redesigned K10 against bf_expand_plain on the card, masks and
    counts in every bit: every
    level of a closest and an any-hit wave (dead tail lanes, levels far
    below their capacity) and the synthetic levels (a full level of
    12,000 units, a count far below the capacity, dead tiles, ids out of
    range, zero direction components, empty slots); one counted launch
    per call, and nothing written past the count."""
    nodes = soup_on_card[0]
    dev = nodes.device
    steps = []
    for seg in _real_lists(soup_on_card).values():
        stat = seg["stat"].to(dev)
        steps += [(lv["units"], stat[lvl], lv["pairs"], seg["rays"], nodes)
                  for lvl, lv in enumerate(seg["levels"][:-1])]
    steps += _synthetic(kc.expand_level, kc.EXPAND_CASES,
                        ("units", "level", "pairs", "rays", "nodes"), dev)
    for step in steps:
        n = int(step[1][bf.NEXT])
        before = bf.LAUNCHES["expand"]
        k = bf.bf_expand(*step)
        torch.cuda.synchronize()
        assert bf.LAUNCHES["expand"] == before + 1
        ref = bf.bf_expand_plain(*step)
        assert all(torch.equal(a[:n], b[:n]) for a, b in zip(k, ref))
        assert int(k[1][:n].sum()) > 0
    units, level, pairs, rays, nodes = steps[-5]          # "sparse"
    cap, n = units.shape[0], int(level[bf.NEXT])
    assert cap > 10 * n
    masks = torch.full((cap, 128), SENTINEL, dtype=torch.int32, device=dev)
    counts = torch.full((cap, 16), SENTINEL, dtype=torch.int32, device=dev)
    bf._launch("expand", dev, units, level, cap, pairs, rays, rays.shape[1],
               nodes, nodes.shape[0], masks, counts)
    torch.cuda.synchronize()
    assert (masks[n:] == SENTINEL).all() and (counts[n:] == SENTINEL).all()
    assert (counts[:n] != SENTINEL).all()


def test_bf_emit_is_its_plain_version(soup_on_card):
    """The redesigned K12 against bf_emit_plain on the card, every entry
    of both lists (filled with -2 beforehand): every level of a closest
    and an any-hit wave and the synthetic levels (every bit set, one child
    in lane 127 alone, regions in both lists, a region not taken between
    two taken, many units of one node, many units past the count, a level
    of 12,000 units); one counted launch per call."""
    dev = soup_on_card[0].device
    steps = []
    for seg in _real_lists(soup_on_card).values():
        stat, levels = seg["stat"].to(dev), seg["levels"]
        mt_lanes = levels[-1]["mt_units"].shape[0] * 128
        steps += [(lv["pairs"], lv["masks"], stat[lvl], lv["dn"], lv["uoff"],
                   lv["base"], max(lv["cap_next"], 1) * 128, mt_lanes)
                  for lvl, lv in enumerate(levels[:-1])]
    steps += _synthetic(kc.emit_level, kc.EMIT_CASES,
                        ("pairs", "masks", "level", "dn", "uoff", "base",
                         "next_lanes", "mt_lanes"), dev)
    for *args, next_lanes, mt_lanes in steps:
        outs = []
        for emit in (bf.bf_emit, bf.bf_emit_plain):
            lists = (torch.full((next_lanes,), -2, dtype=torch.int32,
                                device=dev),
                     torch.full((mt_lanes,), -2, dtype=torch.int32,
                                device=dev))
            before = bf.LAUNCHES["emit"]
            emit(*args, *lists)
            torch.cuda.synchronize()
            assert bf.LAUNCHES["emit"] - before == (1, 0)[len(outs)]
            outs.append(lists)
        (k, ref) = outs
        assert all(torch.equal(a, b) for a, b in zip(k, ref))
        assert sum(int((x != -2).sum()) for x in k) > 0


def test_bf_overflow_retraces_on_the_card(soup_on_card, monkeypatch):
    """With the capacities forced small every segment is traced again
    with what its levels reported they need; nothing is lost."""
    nodes, blocks, meta, _ = soup_on_card
    wn = nodes.reshape(-1, 128)
    rays = _rays(4096, np.inf, nodes.device)
    o, d = rays[0:3].T, rays[3:6].T
    ref = bf.make_bf_tracer(wn, blocks, meta)[0](o, d, TMIN, float("inf"))
    monkeypatch.setattr(bf, "PAIR_CAP_MULT", (1.0,) * 10)
    monkeypatch.setattr(bf, "CAP_SLACK_TILES", 0)
    monkeypatch.setattr(bf, "MT_CAP_MULT", 0.0)
    monkeypatch.setattr(bf, "MT_WIN", 1)
    tc, _ = bf.make_bf_tracer(wn, blocks, meta, seg_rays=1024)
    rec, segs = tc.with_levels(o, d, TMIN, float("inf"))
    assert all(s["traces"] > 1 for s in segs)
    assert all(int(s["stat"][1:, bf.LOST].sum()) == 0 for s in segs)
    assert _bits(rec.t, ref.t) and torch.equal(rec.tri, ref.tri)
    assert tc.with_overflow(o, d, TMIN, float("inf"))[1] == 0


def test_bf_wrappers_refuse_bad_inputs(soup_on_card):
    nodes, blocks, meta, _ = soup_on_card
    dev = nodes.device
    units = torch.zeros(2, dtype=torch.int32, device=dev)
    level = torch.tensor([2, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32,
                         device=dev)
    pairs = torch.arange(256, dtype=torch.int32, device=dev).view(2, 128)
    rays = _rays(256, np.inf, dev)
    with pytest.raises(TypeError):
        bf.bf_expand(units.long(), level, pairs, rays, nodes)
    with pytest.raises(ValueError):
        bf.bf_expand(units, level, pairs.view(4, 64), rays, nodes)
    with pytest.raises(ValueError):
        bf.bf_expand(units, level.cpu(), pairs, rays, nodes)


def test_threefry_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    key = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), 7), 2)
    for n in (1, 513, 262_144):
        gpu = threefry.uniform(key, n, "cuda").cpu()
        cpu = threefry.uniform(key, n, "cpu")
        assert torch.equal(gpu.view(torch.int32), cpu.view(torch.int32))


def _colonnade_on_card(**kw):
    """The reduced colonnade (6 x 3 columns) at 320 x 180 on the card:
    flat, settings (the auto plan resolved), features, tracer pair."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.render import autoplan, integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = RenderSettings(**dict(dict(
        width=320, height=180, spp=8, max_bounces=6, kernel="mis",
        sampler="halton", tracer="packet", instancing="off"), **kw))
    scene, cam = make_colonnade_scene(columns=6, rows=3, sphere_res=(18, 26))
    flat = flatten_scene(scene, cam, s, device="cuda")
    tracers = integrator.make_tracers(flat, s)
    if s.compact_plan == "auto":
        s = autoplan.resolve_auto_plan(flat, s, tracers=tracers)
    return flat, s, analyze_features(flat), tracers


@pytest.mark.parametrize("kw", [
    dict(compact=True, compact_plan="auto"),
    dict(compact=True, stream="on"),
    dict(fuse_shadow=True),
], ids=["auto_plan", "streamed_static_plan", "fuse_shadow"])
def test_bounce_graphs_are_the_eager_bounces_bit_for_bit(kw):
    """Three consecutive samples through captured bounce graphs (the
    first captures, the others replay) against the eager path: radiance
    and rays bit for bit, the same kernel launches, lanes and live
    lanes, and each returned tensor unchanged by the samples after it."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.graphs import BounceGraphs
    from platinum_tpu_torch.utils import telemetry

    flat, s, feats, tracers = _colonnade_on_card(**kw)
    assert integrator.graphs_engage(flat.camera.position.device, tracers, s,
                                    feats)
    graphs = BounceGraphs()
    got = {}
    telemetry.drain()
    telemetry.start()
    try:
        for path in ("eager", "graphs"):
            before = dict(pt.LAUNCHES)
            runs = [integrator.render_sample(
                flat, s, 11 + i, tracers=tracers, return_stats=True,
                features=feats, graphs=graphs if path == "graphs" else None)
                for i in range(3)]
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in pt.LAUNCHES.items()
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
    for k in ("integrator.wave_lanes", "integrator.live_lanes"):
        assert g_count[k] == e_count[k]
    assert g_count["integrator.graph_captures"] == len(graphs) > 0
    assert g_count["integrator.graph_replays"] >= len(graphs)
    if "stream" in kw:
        assert "stream+closest" in g_launch


def test_an_instance_edit_recaptures_the_bounce_graphs():
    """Renderer steps replay bounce graphs; an instance edit drops them,
    the next step captures them anew, and the image after the edit is bit
    for bit the eager path's over the edited scene."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.core.transform import Transform
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.renderer import Renderer
    from platinum_tpu_torch.render.types import RenderSettings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene, cam = make_colonnade_scene(columns=6, rows=3, sphere_res=(18, 26))
    s = RenderSettings(width=320, height=180, spp=16, max_bounces=6,
                       kernel="mis", sampler="halton", tracer="packet",
                       compact=True, instancing="on")
    r = Renderer(scene, device="cuda")
    r.start_render(cam, s)
    r.render()
    r.render()
    first = r._graphs
    assert len(first) > 0 and all(f.capturable for f in r._tracers)
    node = next(scene.node(i.node_id) for i in scene.get_instances()
                if scene.node(i.node_id).name.startswith("col_"))
    old = node.transform
    r.update_instance_transform(node.id, Transform(
        translation=np.asarray(old.translation) + [0.5, 0.0, 0.25],
        rotation=old.rotation, scale=old.scale))
    assert r._graphs is not first and len(r._graphs) == 0
    for _ in range(3):
        r.render()
    assert len(r._graphs) > 0
    accum = torch.zeros_like(r._buckets[0])
    for i in range(3):
        accum = integrator.render_step(r.flat, r.settings, accum, i,
                                       features=r._features,
                                       tracers=r._tracers)
    assert torch.equal(accum, r._buckets[0])


# the small street of portbench/generators/bistro_exterior.py, with more
# leaves in view than the CPU tests' copy
EXTERIOR = dict(bays=2, cards=600, bush_cards=150, trees_per_side=4,
                planters=2, tables=2, strings=3, bulbs_per_string=8,
                cobble=0.5, balusters=4, leaf=0.3, tex=256, sky_size=(64, 128))


def _cutouts_on_card(which):
    """A cutout scene on the card at 320 x 180, 4-bounce MIS with the auto
    plan: the small street streamed (K6's closest hit with per-lane far
    limits in the shadow waves) or the checker-cut colonnade. Returns
    flat, settings (the plan resolved), features, tracer pair."""
    import dataclasses

    from platinum_tpu_torch.render import autoplan, integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = RenderSettings(width=320, height=180, spp=8, max_bounces=4,
                       kernel="mis", sampler="halton", tracer="packet",
                       instancing="off", compact=True, compact_plan="auto")
    if which == "exterior":
        from portbench import harness, scenes

        gen = scenes.load_file(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "portbench", "generators", "bistro_exterior.py"), "gpu_street_")
        scene, cam = harness.port_scene(gen.make(**EXTERIOR))
        s = dataclasses.replace(s, stream="on")
    else:
        from alpha_scenes import checker_columns

        scene, cam = checker_columns("platinum_tpu_torch")
    flat = flatten_scene(scene, cam, s, device="cuda")
    tracers = integrator.make_tracers(flat, s)
    s = autoplan.resolve_auto_plan(flat, s, tracers=tracers)
    feats = analyze_features(flat)
    assert "alpha" in feats
    return flat, s, feats, tracers


ALPHA_COUNTERS = ("integrator.wave_lanes", "integrator.live_lanes",
                  "integrator.alpha_tested", "integrator.alpha_passed",
                  "integrator.alpha_budget_out", "hitfetch.lanes",
                  "hitfetch.kernel_lanes")


@pytest.mark.parametrize("which", ["exterior", "checker_columns"])
def test_captured_alpha_bounces_are_the_eager_bounces_bit_for_bit(which):
    """Three consecutive samples of a cutout scene through captured bounce
    graphs against eager: radiance and rays bit for bit, the same
    launches and the same alpha and fetch counts."""
    from platinum_tpu_torch.ops import hitdata
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.graphs import BounceGraphs
    from platinum_tpu_torch.utils import telemetry

    flat, s, feats, tracers = _cutouts_on_card(which)
    assert integrator.graphs_engage(flat.camera.position.device, tracers, s,
                                    feats)
    graphs = BounceGraphs()
    got = {}
    telemetry.drain()
    telemetry.start()
    try:
        for path in ("eager", "graphs"):
            before = dict(pt.LAUNCHES, **hitdata.LAUNCHES)
            runs = [integrator.render_sample(
                flat, s, 11 + i, tracers=tracers, return_stats=True,
                features=feats, graphs=graphs if path == "graphs" else None)
                for i in range(3)]
            torch.cuda.synchronize()
            now = dict(pt.LAUNCHES, **hitdata.LAUNCHES)
            launched = {k: v - before[k] for k, v in now.items()
                        if v != before[k]}
            got[path] = (runs, launched, telemetry.drain()["counters"])
    finally:
        telemetry.stop()
        telemetry.drain()
    (eager, e_launch, e_count), (graph, g_launch, g_count) = (
        got["eager"], got["graphs"])
    for (a, ra), (b, rb) in zip(eager, graph):
        assert torch.equal(a, b) and torch.equal(ra, rb)
    assert g_launch == e_launch and e_launch["hit_fetch"] > 0
    for k in ALPHA_COUNTERS:
        assert g_count[k] == e_count[k], k
    assert e_count["integrator.alpha_passed"] > 0
    assert g_count["hitfetch.kernel_lanes"] == g_count["hitfetch.lanes"]
    assert g_count["integrator.graph_captures"] == len(graphs) > 0
    assert g_count["integrator.graph_replays"] >= len(graphs)


@pytest.mark.parametrize("which", ["exterior", "checker_columns"])
def test_alpha_hops_through_fetch_hit_are_interpolate_hit_hops(
        which, monkeypatch):
    """The alpha hops and shadow waves fetch through the kernel; the same
    samples with their fetches made by the plain code (`interpolate_hit`
    and the material rows it names), the shaded bounce's fetch left to
    the kernel, give the same image bit for bit."""
    from platinum_tpu_torch.ops import hitdata
    from platinum_tpu_torch.render import integrator

    flat, s, feats, tracers = _cutouts_on_card(which)
    kernel = integrator.fetch_hit
    plain_calls = [0]

    def plain_in_the_loops(geometry, rec, o, d, materials, textures=False,
                           instances=None):
        if sys._getframe(1).f_code.co_name not in ("_alpha_hops",
                                                   "_alpha_shadow"):
            return kernel(geometry, rec, o, d, materials, textures,
                          instances)
        plain_calls[0] += 1
        hd = hitdata.interpolate_hit(geometry, rec, o, d,
                                     instances=instances)
        return hd, hitdata.material_rows(materials, hd.mat_idx, textures)

    out = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(integrator, "fetch_hit", plain_in_the_loops)
        out.append([integrator.render_sample(flat, s, 5 + i, tracers=tracers,
                                             features=feats)
                    for i in range(2)])
    assert plain_calls[0] >= 2 * (2 * integrator.ALPHA_HOPS + 1)
    for a, b in zip(*out):
        assert torch.equal(a, b)
