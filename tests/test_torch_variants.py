"""The packet kernel's variants in platinum_tpu_torch against the JAX
package: the MT precision tiers "high" (K4) and "two_phase" (K5), streamed
leaf blocks (K6) and the near-first octant order (K7), each through the
port's plain version on CPU tensors and JAX's make_packet_tracer in Pallas
interpret mode (one 128-ray packet, one pop per superstep: the same
contract as the default schedule, a fraction of its compile time), on the
random-soup recipe of tests/test_pallas_trace.py and the 24-instance scene
of tests/test_tlas.py; the "default" tier (1-pass bf16) against a numpy
model, since XLA:CPU ignores Precision.DEFAULT and JAX computes "highest"
there; renders with each option against JAX's render_step_n; the flags
carried across by flat_from_numpy; and the refusals of make_tracers and
make_packet_tracer.

Bars (tests/test_pallas_trace.py's): hit sets agree on >= 99.5% of rays
and every disagreement is certified borderline in float64; ids agree
outside t ties (rtol 1e-5, atol 1e-6); t to rtol 1e-4, atol 1e-5 where
the ids agree. "high" holds t to HIGH_T_RTOL where the ids agree (both
sides form the same exact bf16 products; only the order of fp32 sums may
differ) and must move t off the "highest" tier's on >= TIER_DIFF_MIN of
the same-triangle hits. Renders: the slice's per-pixel bar (rtol = atol
= 2e-3 on >= 99.5% of pixels) and image means to 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instanced_scenes import instanced_scene
from platinum_tpu.accel.wide import build_octant_orders as jorders
from platinum_tpu.app.scenes import make_colonnade_scene, make_cornell_scene
from platinum_tpu.ops.pallas_trace import make_packet_tracer as jpacket
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.types import RenderSettings
from test_pallas_trace import _assert_borderline, _build, _random_soup
from test_torch_trace import TMAX_ANY, TMIN, _port_packet, _rays

torch.set_num_threads(1)
ONE_PACKET = dict(packets=1, pops=1)   # JAX schedule for the comparisons
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3
HIGH_T_RTOL = 1e-6
TIER_DIFF_MIN = 0.9


def _soup():
    soup = _random_soup()
    wide, _ = _build(*soup, leaf_cap=16)
    return soup, wide


def _hold_closest(rec_p, rec_r, o, d, soup, certify=True, rtol=1e-4,
                  atol=1e-5):
    """The bars above, port (p) vs reference (r), closest hit; t to
    rtol / atol where the ids agree."""
    hp, hr = rec_p.hit.numpy(), np.asarray(rec_r.hit)
    agree = hp == hr
    assert agree.mean() > 0.995, f"hit sets differ: {(~agree).sum()} rays"
    if certify:
        for i in np.nonzero(~agree)[0]:
            _assert_borderline(i, o, d, *soup, TMIN, np.inf, "closest hit/miss")
    both = hp & hr
    assert both.sum() > 100
    tp, tr = rec_p.t.numpy()[both], np.asarray(rec_r.t)[both]
    trip, trir = rec_p.tri.numpy()[both], np.asarray(rec_r.tri)[both]
    apart = ~np.isclose(tp, tr, rtol=1e-5, atol=1e-6)
    assert ((trip == trir) | ~apart).all() and apart.mean() < 0.005
    same = trip == trir
    np.testing.assert_allclose(tp[same], tr[same], rtol=rtol, atol=atol)
    return both


def _hold_any(occ_p, occ_r, o, d, soup, tmax=TMAX_ANY):
    occ_p, occ_r = occ_p.numpy(), np.asarray(occ_r)
    assert (occ_p == occ_r).mean() > 0.995 and occ_r.sum() > 50
    for i in np.nonzero(occ_p != occ_r)[0]:
        _assert_borderline(i, o, d, *soup, TMIN, tmax, "occlusion")


def _jax_closest(tc, o, d):
    return jax.jit(lambda o, d: tc(o, d, TMIN, jnp.inf))(
        jnp.asarray(o), jnp.asarray(d))


def _jax_any(ta, o, d, tmax=TMAX_ANY):
    return jax.jit(lambda o, d: ta(o, d, TMIN, tmax))(
        jnp.asarray(o), jnp.asarray(d))


@pytest.mark.parametrize("kw", [dict(mt_precision="high"),
                                dict(mt_precision="two_phase"),
                                dict(worder=True)],
                         ids=["high", "two_phase", "oct_order"])
def test_closest_variant_matches_jax(kw):
    """K4, K5 and K7 closest hit: the port's plain version against the
    JAX kernel in the same mode."""
    soup, wide = _soup()
    if kw.get("worder"):
        kw = dict(worder=jorders(wide.nodes))
    jc, _ = jpacket(wide.nodes, wide.tri_blocks, wide.meta, wide.tri_of_slot,
                    **ONE_PACKET, **kw)
    pkw = dict(kw)
    if "worder" in pkw:
        pkw["worder"] = torch.from_numpy(pkw["worder"])
    tc, _ = _port_packet(wide, **pkw)
    o, d = _rays()
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    launches = dict(pt.LAUNCHES)
    high = kw.get("mt_precision") == "high"
    rec = tc(to, td, TMIN, float("inf"))
    _hold_closest(rec, _jax_closest(jc, o, d), o, d, soup,
                  **(dict(rtol=HIGH_T_RTOL, atol=0.0) if high else {}))
    assert pt.LAUNCHES == launches   # CPU tensors never reach the kernel
    if high:   # bf16x3 is not the fp32 tier
        exact = _port_packet(wide)[0](to, td, TMIN, float("inf"))
        same = rec.hit & exact.hit & (rec.tri == exact.tri)
        moved = (rec.t[same] != exact.t[same]).float().mean().item()
        assert same.sum() > 100 and moved >= TIER_DIFF_MIN, moved


def _bf16_np(x):
    """float32 -> nearest-even bf16 -> float32, in numpy."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def test_default_tier_matches_numpy_bf16_model():
    """"default" (the TPU's 1-pass bf16) against a numpy model of it:
    coefficients and features rounded to bf16 (nearest even), products
    summed in float32, K1's accept tests over every block, the least t
    with ties to the lowest slot. Not against JAX: XLA:CPU ignores
    Precision.DEFAULT, so the JAX kernel computes "highest" on the CPU.
    Both sides round the same operands, so only the float32 summation
    order differs; no float64 certification applies to bf16 errors, so
    the hit-set bar stands alone."""
    soup, wide = _soup()
    o, d = _rays()
    f = np.stack([d[:, 0], d[:, 1], d[:, 2],
                  o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                  o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                  o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0],
                  o[:, 0], o[:, 1], o[:, 2], np.ones(len(o), np.float32)])
    coef = wide.tri_blocks.transpose(0, 2, 1).reshape(-1, 10)
    out = (_bf16_np(coef) @ _bf16_np(f)).reshape(-1, 4, 64, len(o))
    s = np.where(out[:, 0] >= 0, 1.0, -1.0).astype(np.float32)
    ad, us, vs, ts = (out[:, q] * s for q in range(4))
    ok = ((ad > pt.DET_EPS) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
          & (ts > np.float32(TMIN) * ad))
    t = np.where(ok, ts / np.maximum(ad, np.float32(1e-37)), np.inf)
    t = t.reshape(-1, len(o))
    slot = np.argmin(t, axis=0)
    t_ref = t[slot, np.arange(len(o))]
    hit = np.isfinite(t_ref)
    tri = np.where(hit, wide.tri_of_slot[slot], -1)

    class Ref:
        pass

    ref = Ref()
    ref.hit, ref.t, ref.tri = hit, np.where(hit, t_ref, np.inf), tri
    tc, _ = _port_packet(wide, mt_precision="default")
    rec = tc(torch.from_numpy(o), torch.from_numpy(d), TMIN, float("inf"))
    _hold_closest(rec, ref, o, d, soup, certify=False)
    # 1-pass bf16 moves hits: the tier is not the fp32 tier
    hi, _ = _port_packet(wide)
    exact = hi(torch.from_numpy(o), torch.from_numpy(d), TMIN, float("inf"))
    assert not torch.equal(rec.t[rec.hit & exact.hit],
                           exact.t[rec.hit & exact.hit])


@pytest.mark.parametrize("tier", ["high", "default", "two_phase"])
def test_any_hit_stays_exact_under_every_tier(tier):
    """Any-hit waves run exact fp32 under every tier, as the JAX kernel's
    `exact=refine or ah[p]` (pallas_trace.py:390) keeps them."""
    _, wide = _soup()
    o, d = (torch.from_numpy(x) for x in _rays())
    _, ta = _port_packet(wide, mt_precision=tier)
    _, ta_exact = _port_packet(wide)
    assert torch.equal(ta(o, d, TMIN, TMAX_ANY), ta_exact(o, d, TMIN, TMAX_ANY))


def test_two_phase_equals_highest_bitwise():
    """The contract of tests/test_pallas_trace.py:275-324 on the port's
    plain version: two_phase returns the "highest" tier's hits, t, ids
    and barycentrics bit for bit (the refine uses K1's product)."""
    soup = _random_soup(t=700, seed=3)
    wide, _ = _build(*soup, leaf_cap=16)
    rng = np.random.default_rng(1)
    o = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tc_hi, _ = _port_packet(wide)
    tc_tp, _ = _port_packet(wide, mt_precision="two_phase")
    r1, r2 = tc_hi(o, d, TMIN, 1e30), tc_tp(o, d, TMIN, 1e30)
    assert r1.hit.sum() > 1000
    for a, b in ((r1.hit, r2.hit), (r1.t, r2.t), (r1.tri, r2.tri),
                 (r1.bary, r2.bary)):
        assert torch.equal(a, b)


def test_two_phase_exact_on_rays_that_leave_a_surface():
    """Rays that leave a surface, as every bounce and shadow ray does: the
    port's two_phase returns the "highest" tier bit for bit and agrees
    with the JAX kernel's "highest" under the bars above. The JAX kernel's
    own two_phase is not held here: it loses hits on such rays (loose
    phantoms of the surface's own blocks near t = tmin take both candidate
    slots and push the winner out), and the port does not copy that fault
    (it walks such rays again with exact blocks; ROADMAP section 3). Each
    hit the JAX two_phase loses is witnessed in float64: a brute-force
    Moller-Trumbore over every triangle finds it at the port's t."""
    from platinum_tpu_torch.app.scenes import (
        make_colonnade_scene as port_colonnade)
    from platinum_tpu_torch.render.flatten import flatten_scene

    scene, cam = port_colonnade(columns=6, rows=3, sphere_res=(12, 16))
    flat = flatten_scene(scene, cam, RenderSettings(
        width=16, height=16, tracer="packet", instancing="off"),
        device="cpu")
    rng = np.random.default_rng(4)
    n = 1024
    geo = flat.geometry.tri_geo.numpy()
    rows = geo[rng.integers(0, len(geo), n)]
    b = rng.random((n, 2)).astype(np.float32)
    b = np.where(b.sum(-1, keepdims=True) > 1, 1 - b, b)
    o = (rows[:, 0:3] + rows[:, 3:6] * b[:, 0:1]
         + rows[:, 6:9] * b[:, 1:2]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    arrays = (flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta,
              flat.wbvh_slot)
    tc_hi, _ = pt.make_packet_tracer(*arrays)
    tc_tp, _ = pt.make_packet_tracer(*arrays, mt_precision="two_phase")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    r1, r2 = tc_hi(to, td, TMIN, float("inf")), tc_tp(to, td, TMIN,
                                                       float("inf"))
    assert r1.hit.sum() > n // 2
    for a, c in ((r1.hit, r2.hit), (r1.t, r2.t), (r1.tri, r2.tri),
                 (r1.bary, r2.bary)):
        assert torch.equal(a, c)
    jargs = [x.numpy() for x in arrays]
    j_hi, _ = jpacket(*jargs, **ONE_PACKET)
    j_tp, _ = jpacket(*jargs, mt_precision="two_phase", **ONE_PACKET)
    ref = _jax_closest(j_hi, o, d)
    hj, hp = np.asarray(ref.hit), r2.hit.numpy()
    assert (hj == hp).mean() > 0.995
    same = hj & hp & (np.asarray(ref.tri) == r2.tri.numpy())
    assert same.sum() > 0.99 * (hj & hp).sum()
    np.testing.assert_allclose(r2.t.numpy()[same], np.asarray(ref.t)[same],
                               rtol=1e-4, atol=1e-5)
    lost = np.nonzero(hp & ~np.asarray(_jax_closest(j_tp, o, d).hit))[0]
    print(f"JAX two_phase loses {lost.size} of {int(hp.sum())} hits of "
          f"{n} rays that leave a surface")
    g = geo[:, 0:9].astype(np.float64)
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    for i in lost:
        o64, d64 = o[i].astype(np.float64), d[i].astype(np.float64)
        pv = np.cross(d64, e2)
        det = (e1 * pv).sum(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            sv = o64 - v0
            u = (sv * pv).sum(-1) * inv
            qv = np.cross(sv, e1)
            v = (d64 * qv).sum(-1) * inv
            t = (e2 * qv).sum(-1) * inv
            ok = ((np.abs(det) > 1e-12) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (t > TMIN))
        assert ok.any(), f"ray {i}: no hit in float64"
        np.testing.assert_allclose(t[ok].min(), float(r2.t[i]), rtol=1e-4,
                                   atol=1e-5)


def test_stream_matches_jax_one_level():
    """K6 over one tree: JAX stream=True against the port's streamed
    tracer, closest hit and any hit."""
    soup, wide = _soup()
    jc, ja = jpacket(wide.nodes, wide.tri_blocks, wide.meta, wide.tri_of_slot,
                     stream=True, **ONE_PACKET)
    tc, ta = _port_packet(wide, stream=True)
    o, d = _rays()
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    _hold_closest(tc(to, td, TMIN, float("inf")), _jax_closest(jc, o, d),
                  o, d, soup)
    _hold_any(ta(to, td, TMIN, TMAX_ANY), _jax_any(ja, o, d), o, d, soup)


def test_stream_matches_jax_instanced():
    """K6 over the two-level tree (the JAX flatten streams instanced
    structures too): the 24-instance scene, flattened by JAX and carried
    across, JAX stream=True against the port's streamed tracer. Hit sets
    agree on >= 99.5%, t to 1e-4 and instances equal where the triangles
    do."""
    jscene, jcam = instanced_scene("platinum_tpu")
    jflat = jflatten(jscene, jcam, JSettings(
        width=48, height=48, instancing="on", tracer="packet", stream="on"),
        accel_min_tris=1)
    assert jflat.wbvh_stream
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    assert flat.wbvh_stream is True
    jc, ja = jpacket(jflat.wbvh_nodes, jflat.wbvh_tris, jflat.wbvh_meta,
                     jflat.wbvh_slot, inst_feat=jflat.instances.feat,
                     stream=True, **ONE_PACKET)
    tc, ta = integrator.make_tracers(flat, RenderSettings(tracer="packet"))
    o, d = _rays(seed=3)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    launches = dict(pt.LAUNCHES)
    rec_p = tc(to, td, TMIN, float("inf"))
    rec_r = _jax_closest(jc, o, d)
    hp, hr = rec_p.hit.numpy(), np.asarray(rec_r.hit)
    assert (hp == hr).mean() > 0.995 and hr.sum() > 100
    same = hp & hr & (rec_p.tri.numpy() == np.asarray(rec_r.tri))
    assert same.sum() > 0.99 * (hp & hr).sum()
    np.testing.assert_allclose(rec_p.t.numpy()[same], np.asarray(rec_r.t)[same],
                               rtol=1e-4, atol=1e-5)
    assert np.array_equal(rec_p.inst.numpy()[same],
                          np.asarray(rec_r.inst)[same])
    occ_p, occ_r = ta(to, td, TMIN, 6.0).numpy(), np.asarray(
        _jax_any(ja, o, d, 6.0))
    assert (occ_p == occ_r).mean() > 0.995 and occ_r.sum() > 50
    assert pt.LAUNCHES == launches


def _hold_render(img, ref, name):
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img.mean() / ref.mean() - 1.0)
    print(f"{name}: {int((~close).sum())} of {close.size} pixels outside "
          f"rtol={PIX_RTOL} atol={PIX_ATOL}; mean {img.mean():.6f} vs "
          f"{ref.mean():.6f} (rel {rel:.2e})")
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert rel <= MEAN_RTOL


CORNELL = dict(width=24, height=24, spp=1, max_bounces=8, kernel="mis",
               sampler="halton", tracer="packet")


@pytest.fixture(scope="module")
def cornell_refs():
    """JAX's Cornell renders through the packet kernel: "highest" (the
    reference of the exact variants K5-K7) and "high"."""
    scene, cam = make_cornell_scene()
    refs = {}
    for tier in ("highest", "high"):
        jset = JSettings(**CORNELL, mt_precision=tier)
        jflat = jflatten(scene, cam, jset, accel_min_tris=1)
        refs[tier] = np.asarray(jintegrator.render_step_n(
            jflat, jset, jnp.zeros((jset.num_pixels, 3)), jnp.int32(0), 1,
            features=janalyze(jflat)))
    return scene, cam, refs


@pytest.mark.parametrize("option", [dict(mt_precision="high"),
                                    dict(mt_precision="two_phase"),
                                    dict(oct_order=True), dict(stream="on")],
                         ids=["high", "two_phase", "oct_order", "stream"])
def test_cornell_render_with_option_matches_jax(cornell_refs, option):
    """Cornell (flattened by JAX with a wide BVH, carried across) through
    the port's packet tracer with each option, against JAX's
    render_step_n: "high" against JAX's "high", the exact variants
    against JAX's "highest"."""
    scene, cam, refs = cornell_refs
    kw = dict(CORNELL, **option)
    jflat = jflatten(scene, cam, JSettings(**kw), accel_min_tris=1)
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    settings = RenderSettings(**kw)
    assert flat.wbvh_stream == (option.get("stream") == "on")
    img = integrator.render_step_n(
        flat, settings, torch.zeros((settings.num_pixels, 3)), 0, 1,
        features=analyze_features(flat)).numpy()
    ref = refs["high" if option.get("mt_precision") == "high" else "highest"]
    _hold_render(img, ref, f"cornell {option}")


def test_colonnade_stream_render_matches_jax():
    """The small colonnade flattened with stream="on": JAX's render_step_n
    through its stream kernel against the port's streamed tracer."""
    scene, cam = make_colonnade_scene(sphere_res=(12, 16))
    kw = dict(width=32, height=32, spp=1, max_bounces=8, kernel="mis",
              sampler="halton", tracer="packet", instancing="off",
              stream="on")
    jset = JSettings(**kw)
    jflat = jflatten(scene, cam, jset)
    assert jflat.wbvh_stream
    ref = np.asarray(jintegrator.render_step_n(
        jflat, jset, jnp.zeros((jset.num_pixels, 3)), jnp.int32(0), 1,
        features=janalyze(jflat)))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    img = integrator.render_step_n(
        flat, RenderSettings(**kw), torch.zeros((jset.num_pixels, 3)), 0, 1,
        features=analyze_features(flat)).numpy()
    _hold_render(img, ref, "colonnade stream")
    assert ref.mean() > 0.5


def test_flat_from_numpy_carries_stream_and_order():
    scene, cam = make_cornell_scene()
    for stream in ("on", "off"):
        jflat = jflatten(scene, cam, JSettings(width=8, height=8,
                                               stream=stream),
                         accel_min_tris=1)
        host = jax.tree.map(np.asarray, jflat)
        flat = flat_from_numpy(host, "cpu")
        assert flat.wbvh_stream is (stream == "on")
        assert flat.wbvh_order.dtype == torch.int32
        assert np.array_equal(flat.wbvh_order.numpy(), host.wbvh_order)


@pytest.mark.parametrize("instancing", ["off", "on"])
@pytest.mark.parametrize("stream", ["on", "auto"])
def test_flatten_stream_decision_matches_jax(instancing, stream):
    """The port's flatten decides wbvh_stream as JAX's does (baked:
    flatten.py:528-534, instanced: :669-670) and builds the octant orders
    of both trees (:560, :778) bit for bit."""
    from platinum_tpu_torch.render.flatten import flatten_scene

    kw = dict(width=16, height=16, tracer="packet", instancing=instancing,
              stream=stream)
    jflat = jflatten(*instanced_scene("platinum_tpu"), JSettings(**kw),
                     accel_min_tris=1)
    flat = flatten_scene(*instanced_scene("platinum_tpu_torch"),
                         RenderSettings(**kw), accel_min_tris=1,
                         device="cpu")
    assert flat.wbvh_stream is bool(jflat.wbvh_stream)
    assert flat.wbvh_stream == (stream == "on")
    assert (flat.instances is not None) == (instancing == "on")
    assert np.array_equal(flat.wbvh_order.numpy(),
                          np.asarray(jflat.wbvh_order))


@pytest.fixture(scope="module")
def small_flats():
    scene, cam = make_cornell_scene()
    out = {}
    for stream in ("on", "off"):
        jflat = jflatten(scene, cam, JSettings(width=8, height=8,
                                               stream=stream),
                         accel_min_tris=1)
        out[stream] = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    return out


@pytest.mark.parametrize("stream,kw,match", [
    ("on", dict(mt_precision="two_phase"), "two_phase"),
    ("off", dict(mt_precision="bf16"), "unknown mt_precision"),
    ("off", dict(mt_precision="high", tracer="brute"), "packet kernel"),
    ("off", dict(oct_order=True, tracer="brute"), "packet kernel")])
def test_make_tracers_refuses(small_flats, stream, kw, match):
    """Combinations the JAX package refuses, and packet-kernel options
    asked of the brute tracer, raise instead of tracing otherwise."""
    with pytest.raises(ValueError, match=match):
        integrator.make_tracers(small_flats[stream], RenderSettings(**kw))


def test_make_packet_tracer_refuses():
    _, wide = _soup()
    with pytest.raises(ValueError, match="two_phase"):
        _port_packet(wide, mt_precision="two_phase", stream=True)
    with pytest.raises(ValueError, match="unknown mt_precision"):
        _port_packet(wide, mt_precision="fp16")
    with pytest.raises(ValueError, match="worder"):
        _port_packet(wide, worder=torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="two_phase"):
        rays = torch.zeros((8, 4))
        pt.trace_wide(rays, torch.from_numpy(wide.nodes).reshape(-1, 16, 8),
                      torch.from_numpy(wide.tri_blocks),
                      torch.from_numpy(wide.meta), False,
                      mt_precision="two_phase", stream=True)
