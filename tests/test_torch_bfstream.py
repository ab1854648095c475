"""The port's breadth-first tracer (ops/bfstream.py) and the plain versions
of its five kernels (K10-K14) against the JAX package's ops/bfstream.py,
on the CPU.

Inputs come from numpy seeds: the random soup of tests/test_pallas_trace.py
(700 triangles, 1,024 rays) and the spheres scene's camera wave (24x30
rays). Both sides cut waves into segments of SEG = 256 rays, so that every
segment has two ray tiles and the JAX kernels, in interpret mode, compile
once per tree (their compilation and interpretation are most of this
module's time). The JAX side is run level by level as `_segment` runs it
(bfstream.py:949-1005) and as a whole by `make_bf_tracer`. Bars: every
integer table of every level bitwise (masks, per-child counts, distinct
nodes, regions, unit tables, the MT cursor), every live region lane the
same ray as JAX's payload lane and every dead lane dead; K13's t, slot and
barycentrics bitwise at "highest" (XLA:CPU sums the ten products in order
with FMAs, as mt_block.cuh does), "high" to rtol 1e-5 / atol 1e-6 with
equal slots (tests/test_torch_raystream.py's K15 bar: the summation order
differs), "default" against a numpy model of the one-pass bf16 product
(XLA:CPU ignores Precision.DEFAULT); K14 bitwise; the tracer's hit set,
occlusion and t bitwise at "highest", triangle ids equal except on exactly
equal t, barycentrics equal where ids are (tests/test_bfstream.py:17-74);
the render to tests/test_bfstream.py:117-153's bar of 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_colonnade_scene as jcolonnade
from platinum_tpu.app.scenes import make_cornell_scene as jcornell
from platinum_tpu.app.scenes import make_spheres_scene as jspheres
from platinum_tpu.models.camera_rays import spawn_camera_rays
from platinum_tpu.ops import bfstream as jbf
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app.scenes import make_colonnade_scene
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.ops import bfstream as bf
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings
from instanced_scenes import instanced_scene
from test_pallas_trace import _build, _random_soup

torch.set_num_threads(1)
SEG = 256
TMIN, TMAX_ANY = 1e-3, 12.0
T_RTOL, T_ATOL = 1e-5, 1e-6
BIG = jbf.BIG
LANES = 128


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _soup_rays(seed, r=1024):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def soup():
    wide, _ = _build(*_random_soup(t=700, seed=3), leaf_cap=16)
    return (wide.nodes, wide.tri_blocks, wide.meta.astype(np.int32),
            wide.tri_of_slot.astype(np.int32))


@pytest.fixture(scope="module")
def spheres():
    """The spheres scene's tree (accel_min_tris=1, as test_bfstream.py
    builds it) and its 24x30 camera wave, as numpy."""
    scene, cam = jspheres(grid=2)
    flat = jflatten(scene, cam, JSettings(width=24, height=30, spp=1,
                                          tracer="packet", instancing="off"),
                    accel_min_tris=1)
    n = 24 * 30
    px = jnp.arange(n, dtype=jnp.uint32) % 24
    py = jnp.arange(n, dtype=jnp.uint32) // 24
    o, d = spawn_camera_rays(flat.camera, px, py, jnp.zeros((n, 2)) + 0.5,
                             jnp.zeros((n, 2)) + 0.5)
    arrs = tuple(np.asarray(x) for x in (flat.wbvh_nodes, flat.wbvh_tris,
                                         flat.wbvh_meta, flat.wbvh_slot))
    return arrs, np.asarray(o, np.float32), np.asarray(d, np.float32)


def _jax_caps(rt, depth):
    """bfstream.py:934-947 with the JAX module's (patchable) constants."""
    caps = [rt]
    for lvl in range(1, depth + 2):
        mult = jbf.PAIR_CAP_MULT[min(lvl, len(jbf.PAIR_CAP_MULT) - 1)]
        caps.append(int(np.ceil(mult * rt)) + jbf.CAP_SLACK_TILES)
    mt_cap = int(np.ceil(jbf.MT_CAP_MULT * rt)) + 512
    return caps, -(-mt_cap // jbf.MT_WIN) * jbf.MT_WIN


def _jax_levels(arrs, o, d, tmax):
    """JAX's `_segment` run level by level on each SEG-ray segment of the
    wave (no sort: both trees have fewer than 65 nodes): per segment the
    rays' payload rows, every level's kernel outputs, the MT list and
    K13's / K14's results at "highest" for closest hit."""
    nodes, blocks, meta = arrs[:3]
    depth = jbf._tree_depth(meta)
    n_nodes = nodes.shape[0]
    nodes16 = jnp.asarray(nodes).reshape(n_nodes, 16, 8)
    meta_j = jnp.asarray(meta, jnp.int32)
    r = o.shape[0]
    rows = np.concatenate([o.T, d.T, np.full((1, r), TMIN, np.float32),
                           np.minimum(tmax, 1e30)[None].astype(np.float32)])
    segs = []
    for lo in range(0, r, SEG):
        take = min(SEG, r - lo)
        rt = -(-take // LANES)
        pay = np.zeros((8, rt * LANES), np.float32)
        pay[:, :take] = rows[:, lo:lo + take]
        pay[6, take:], pay[7, take:] = 1e30, -1e30
        caps, mt_cap = _jax_caps(rt, depth)
        units = jnp.zeros((rt,), jnp.int32)
        n = jnp.full((1,), rt, jnp.int32)
        pairs = jnp.asarray(pay.reshape(8, rt, LANES).transpose(1, 0, 2))
        mtcur = jnp.zeros((1,), jnp.int32)
        mtp = jnp.zeros((mt_cap, 8, LANES), jnp.float32)
        mtu = jnp.zeros((mt_cap,), jnp.int32)
        levels = []
        for lvl in range(depth + 1):
            ct, cn = caps[lvl], caps[lvl + 1]
            masks, ucnt = jbf._build_expand(ct, n_nodes, True)(
                units, n, pairs, nodes16)
            pn = jnp.zeros((cn, 8, LANES), jnp.float32)
            dn, base, un, nn, mtcur, ovf, pn, mtp, mtu = jbf._build_prefix(
                ct, cn, mt_cap, n_nodes * 16, True)(
                units, n, ucnt, meta_j, mtcur, pn, mtp, mtu)
            pn, mtp = jbf._build_emit(ct, cn, mt_cap, True)(
                pairs, masks, n, dn, ucnt, base, pn, mtp)
            levels.append(dict(
                n=int(n[0]), cap=ct, masks=np.asarray(masks),
                ucnt=np.asarray(ucnt), dn=np.asarray(dn),
                base=np.asarray(base), units_next=np.asarray(un),
                n_next=int(nn[0]), mtcur=int(mtcur[0]), ovf=int(ovf[0]),
                pairs_next=np.asarray(pn), jargs=(masks, n, dn, ucnt, base)))
            units, n, pairs = un, nn, pn
        segs.append(dict(payload=pay, lo=lo, take=take, rt=rt, levels=levels,
                         mt_pairs=np.asarray(mtp), mtu=np.asarray(mtu),
                         n_mt=int(mtcur[0]), mt_cap=mt_cap, jmt=(mtp, mtu)))
    return segs


def _jax_mt(arrs, seg, any_hit, tier):
    """K13 of the JAX module over the segment's MT list, window by window
    as `_segment` calls it: (mt_cap, 8, 128) rows t, sid, u, v."""
    blocks16 = jnp.pad(jnp.asarray(arrs[1]), ((0, 0), (0, 6), (0, 0)))
    mtp, mtu = seg["jmt"]
    wins = []
    for w0 in range(0, seg["mt_cap"], jbf.MT_WIN):
        n_w = jnp.clip(seg["n_mt"] - w0, 0, jbf.MT_WIN).reshape(1)
        wins.append(jbf._build_mt(jbf.MT_WIN, arrs[1].shape[0], any_hit,
                                  tier, True)(
            mtu[w0:w0 + jbf.MT_WIN], n_w, mtp[w0:w0 + jbf.MT_WIN], blocks16))
    return jnp.concatenate(wins, axis=0)


def _jax_bwd(seg, mt_res):
    """K14 of the JAX module, deepest level first: each level's (cap, 8,
    128) results."""
    res = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (1, 8, LANES), 1) <= 1, BIG, 0.0)
    cap_child, out = 1, []
    for lv in reversed(seg["levels"]):
        masks, n, dn, ucnt, base = lv["jargs"]
        res = jbf._build_bwd(lv["cap"], cap_child, seg["mt_cap"], True)(
            masks, n, dn, ucnt, base, res, mt_res)
        cap_child = lv["cap"]
        out.append(np.asarray(res))
    return out[::-1]


def _port_levels(arrs, o, d, tmax, any_hit=False, tier="highest"):
    tc, ta = bf.make_bf_tracer(*(_t(x) for x in arrs), sort=False,
                               seg_rays=SEG, mt_precision=tier)
    return (ta if any_hit else tc).with_levels(_t(o), _t(d), TMIN, _t(tmax))


def _unpack(ucnt, n):
    """JAX's packed 8-bit counts (4 per int32) -> (n, 16)."""
    w = ucnt[:n * 4].reshape(n, 4, 1).astype(np.int64)
    return ((w >> (8 * np.arange(4))) & 255).reshape(n, 16)


def _hold_lanes(port_lanes, jax_rows, rays, n_tiles, what):
    """Each live port lane names the ray whose payload JAX's lane holds;
    each dead lane is dead on both sides."""
    lanes = port_lanes[:n_tiles * LANES]
    rows = jax_rows[:n_tiles].transpose(1, 0, 2).reshape(8, -1)
    live = lanes >= 0
    assert np.array_equal(rows[:, live], rays[:, lanes[live]]), what
    assert (rows[6, ~live] == 1e30).all() and (rows[7, ~live] == -1e30).all()
    return int(live.sum())


def _hold_levels(arrs, o, d, tmax):
    """K10-K12 level by level, K13 (closest, "highest") and K14: the
    port's plain versions against the JAX kernels on the same wave."""
    jsegs = _jax_levels(arrs, o, d, tmax)
    _, psegs = _port_levels(arrs, o, d, tmax)
    assert len(jsegs) == len(psegs) > 1
    totals = np.zeros(3, np.int64)
    for js, ps in zip(jsegs, psegs):
        assert ps["traces"] == 1 and ps["caps"][0] == js["rt"]
        rays = np.zeros((8, o.shape[0]), np.float32)
        rays[:, js["lo"]:js["lo"] + js["take"]] = js["payload"][:, :js["take"]]
        stat = ps["stat"].numpy()
        plv, pmt = ps["levels"][:-1], ps["levels"][-1]
        for lvl, (jl, pl_) in enumerate(zip(js["levels"], plv)):
            n, row = jl["n"], stat[lvl + 1]
            assert stat[lvl][bf.NEXT] == n
            assert np.array_equal(pl_["masks"][:n].numpy(), jl["masks"][:n])
            assert np.array_equal(pl_["counts"][:n].numpy(),
                                  _unpack(jl["ucnt"], n))
            assert np.array_equal(pl_["dn"][:n].numpy(), jl["dn"][:n])
            nd = row[bf.DISTINCT]
            assert nd == (jl["dn"][n - 1] + 1 if n else 0)
            assert np.array_equal(pl_["base"][:nd * 16].numpy(),
                                  jl["base"][:nd * 16])
            assert row[bf.NEXT] == jl["n_next"] and row[bf.LOST] == jl["ovf"]
            assert row[bf.MT_CUR] == jl["mtcur"]
            if lvl + 1 < len(plv):
                nxt = plv[lvl + 1]
                assert np.array_equal(nxt["units"][:jl["n_next"]].numpy(),
                                      jl["units_next"][:jl["n_next"]])
                totals[0] += _hold_lanes(nxt["pairs"].reshape(-1).numpy(),
                                         jl["pairs_next"], rays,
                                         jl["n_next"], f"level {lvl + 1}")
            else:
                assert jl["n_next"] == 0
        n_mt = js["n_mt"]
        assert np.array_equal(pmt["mt_units"][:n_mt].numpy(),
                              js["mtu"][:n_mt])
        totals[1] += _hold_lanes(pmt["mt_pairs"].numpy(), js["mt_pairs"],
                                 rays, n_mt, "MT list")
        # K13 closest at "highest" and K14, deepest level first: bitwise
        jmt = _jax_mt(arrs, js, False, "highest")
        _hold_results(pmt["mt"], jmt, n_mt)
        res = None
        for lvl, jres in reversed(list(enumerate(_jax_bwd(js, jmt)))):
            lv = plv[lvl]
            res = bf.bf_bwd_plain(lv["masks"], ps["stat"][lvl], lv["dn"],
                                  lv["uoff"], lv["base"], res, pmt["mt"])
            _hold_results(res, jres, js["levels"][lvl]["n"])
        totals[2] += n_mt
    return totals


def _hold_results(res, jres, n_tiles):
    """(t, sid, u, v) flat lanes against JAX's (cap, 8, 128) rows over the
    first n_tiles: misses are (BIG, BIG) there, (inf, -1) here."""
    rows = np.asarray(jres)[:n_tiles].transpose(1, 0, 2).reshape(8, -1)
    k = n_tiles * LANES
    t, sid, u, v = (x[:k].numpy() for x in res)
    hit = rows[1] < BIG
    assert np.array_equal(sid >= 0, hit)
    assert np.array_equal(sid[hit], rows[1][hit].astype(np.int32))
    assert np.isinf(t[~hit]).all()
    for a, b in ((t, rows[0]), (u, rows[2]), (v, rows[3])):
        assert np.array_equal(a[hit].view(np.int32), b[hit].view(np.int32))
    return int(hit.sum())


def test_k10_k12_k14_match_jax_level_by_level_on_the_soup(soup):
    o, d = _soup_rays(1)
    totals = _hold_levels(soup, o, d, np.full(1024, np.inf, np.float32))
    assert totals[0] > 1024 and totals[1] > 1024 and totals[2] > 8


def test_k10_k12_k14_match_jax_level_by_level_on_the_spheres(spheres):
    arrs, o, d = spheres
    assert jbf._tree_depth(arrs[2]) == 2
    totals = _hold_levels(arrs, o, d, np.full(o.shape[0], np.inf,
                                              np.float32))
    assert totals[0] > 0 and totals[1] > 0


def _bf16_np(x):
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


@pytest.fixture(scope="module")
def soup_mt(soup):
    """One segment's real MT list on both sides (closest-hit rays with a
    per-ray tmax, so that the tmax test matters)."""
    o, d = _soup_rays(2)
    tmax = np.random.default_rng(3).uniform(2.0, 16.0, 1024).astype(
        np.float32)
    js = _jax_levels(soup, o, d, tmax)[0]
    ps = _port_levels(soup, o, d, tmax)[1][0]
    rays = np.zeros((8, 1024), np.float32)
    rays[:, :js["take"]] = js["payload"][:, :js["take"]]
    return js, ps, _t(rays)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_k13_plain_matches_the_jax_kernel(soup, soup_mt, tier, any_hit):
    js, ps, rays = soup_mt
    pmt = ps["levels"][-1]
    n_mt = js["n_mt"]
    level = ps["stat"][-1]
    res = bf.bf_mt_plain(pmt["mt_pairs"], pmt["mt_units"], level, rays,
                         _t(soup[1]), any_hit, tier)
    k = n_mt * LANES
    t, sid, u, v = (x[:k].numpy() for x in res)
    lanes = pmt["mt_pairs"][:k].numpy()
    if tier == "default":
        # a numpy model of the 1-pass bf16 product (XLA:CPU computes
        # Precision.DEFAULT in fp32)
        r = rays.numpy()[:, np.maximum(lanes, 0)]
        feat = np.concatenate([r[3:6], np.cross(r[0:3].T, r[3:6].T).T,
                               r[0:3], np.ones((1, k), np.float32)])
        coef = _bf16_np(soup[1][np.repeat(pmt["mt_units"][:n_mt].numpy(),
                                          LANES)])
        out = np.einsum("nkm,kn->nm", coef, _bf16_np(feat),
                        dtype=np.float32).reshape(k, 4, 64)
        s = np.where(out[:, 0] >= 0, 1.0, -1.0).astype(np.float32)
        ad, us, vs, ts = (out[:, q] * s for q in range(4))
        with np.errstate(invalid="ignore", over="ignore"):
            ok = ((ad > 1e-12) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
                  & (ts > r[6][:, None] * ad) & (ts < r[7][:, None] * ad)
                  & (lanes >= 0)[:, None])
            t_ref = np.where(ok, ts / np.maximum(ad, 1e-37), np.inf).min(1)
        hit_ref = ok.any(1)
        assert (hit_ref == (sid >= 0)).mean() > 0.995 and hit_ref.sum() > 20
        if not any_hit:
            both = hit_ref & (sid >= 0)
            np.testing.assert_allclose(t[both], t_ref[both], rtol=T_RTOL,
                                       atol=T_ATOL)
        return
    jmt = np.asarray(_jax_mt(soup, js, any_hit, tier))
    rows = jmt[:n_mt].transpose(1, 0, 2).reshape(8, -1)
    hit = rows[1] < BIG
    assert np.array_equal(sid >= 0, hit) and hit.sum() > 20
    if any_hit:
        assert (t[hit] == 0).all() and np.isinf(t[~hit]).all()
        return
    assert np.array_equal(sid[hit], rows[1][hit].astype(np.int32))
    if tier == "highest":
        _hold_results(res, jmt, n_mt)
    else:
        for a, b in ((t, rows[0]), (u, rows[2]), (v, rows[3])):
            np.testing.assert_allclose(a[hit], b[hit], rtol=T_RTOL,
                                       atol=T_ATOL)


@pytest.fixture(scope="module")
def jax_soup_tracers(soup):
    return jbf.make_bf_tracer(*soup, seg_rays=SEG)


def _hold_tracer(rec, jrec, bitwise=True):
    hit = np.asarray(jrec.hit)
    assert np.array_equal(rec.hit.numpy(), hit)
    t, jt = rec.t.numpy(), np.asarray(jrec.t)
    assert np.array_equal(t[hit].view(np.int32), jt[hit].view(np.int32))
    tri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    diff = tri != jtri
    assert (t[diff] == jt[diff]).all()              # ties only
    same = hit & ~diff
    assert np.array_equal(rec.bary.numpy()[same].view(np.int32),
                          np.asarray(jrec.bary)[same].view(np.int32))
    return int(hit.sum())


def test_tracer_matches_jax_on_the_soup(soup, jax_soup_tracers):
    """1,024 rays in four segments: closest hit, occlusion, active masks
    and per-ray tmax against JAX's make_bf_tracer; and the port's packet
    tracer (the plain version of K1/K2) agrees bit for bit."""
    jc, ja = jax_soup_tracers
    o, d = _soup_rays(1)
    jrec, jovf = jc.with_overflow(o, d, TMIN, 1e30, None)
    tc, ta = bf.make_bf_tracer(*(_t(x) for x in soup), seg_rays=SEG)
    before = dict(bf.LAUNCHES)
    rec, ovf = tc.with_overflow(_t(o), _t(d), TMIN, float("inf"))
    assert int(jovf) == 0 and ovf == 0
    assert bf.LAUNCHES == before      # CPU tensors never reach a kernel
    assert _hold_tracer(rec, jrec) > 100
    rng = np.random.default_rng(8)
    act = rng.random(1024) < 0.5
    jocc = np.asarray(ja(o, d, TMIN, TMAX_ANY))
    occ = ta(_t(o), _t(d), TMIN, TMAX_ANY)
    assert np.array_equal(occ.numpy(), jocc) and jocc.sum() > 50
    jocc_m = np.asarray(ja(o, d, TMIN, TMAX_ANY, jnp.asarray(act)))
    occ_m = ta(_t(o), _t(d), TMIN, TMAX_ANY, active=_t(act))
    assert np.array_equal(occ_m.numpy(), jocc_m)
    assert not occ_m[~_t(act)].any()
    assert np.array_equal(occ_m[_t(act)].numpy(), jocc[act])
    tmax = rng.uniform(2.0, 16.0, 1024).astype(np.float32)
    jrec_m = jc(o, d, TMIN, jnp.asarray(tmax), jnp.asarray(act))
    rec_m = tc(_t(o), _t(d), TMIN, _t(tmax), active=_t(act))
    _hold_tracer(rec_m, jrec_m)
    assert not rec_m.hit[~_t(act)].any()
    pc, pa = pt.make_packet_tracer(*(_t(x) for x in soup))
    k1 = pc(_t(o), _t(d), TMIN, float("inf"))
    assert torch.equal(rec.hit, k1.hit)
    assert torch.equal(rec.t[k1.hit].view(torch.int32),
                       k1.t[k1.hit].view(torch.int32))
    assert torch.equal(occ, pa(_t(o), _t(d), TMIN, TMAX_ANY))


def test_sorted_waves_match_jax(soup):
    """sort=True: both sides order the wave by the octant + Morton key and
    unsort the results."""
    jc, _ = jbf.make_bf_tracer(*soup, seg_rays=SEG, sort=True)
    o, d = _soup_rays(4)
    jrec = jc(o, d, TMIN, 1e30)
    tc, _ = bf.make_bf_tracer(*(_t(x) for x in soup), seg_rays=SEG,
                              sort=True)
    rec = tc(_t(o), _t(d), TMIN, float("inf"))
    assert _hold_tracer(rec, jrec) > 100
    unsorted, _ = bf.make_bf_tracer(*(_t(x) for x in soup), seg_rays=SEG,
                                    sort=False)
    assert torch.equal(unsorted(_t(o), _t(d), TMIN, float("inf")).t, rec.t)


def test_tracer_matches_jax_on_the_spheres_camera_wave(spheres):
    """Three segments of 256 rays, the last with 48 padding lanes."""
    arrs, o, d = spheres
    jc, ja = jbf.make_bf_tracer(*arrs, seg_rays=SEG)
    jrec, jovf = jc.with_overflow(o, d, TMIN, 1e30, None)
    tc, ta = bf.make_bf_tracer(*(_t(x) for x in arrs), seg_rays=SEG)
    rec, segs = tc.with_levels(_t(o), _t(d), TMIN, float("inf"))
    assert int(jovf) == 0 and len(segs) == 3 and segs[-1]["take"] == 208
    assert _hold_tracer(rec, jrec) > 300
    # the segment size changes no result
    whole, _ = bf.make_bf_tracer(*(_t(x) for x in arrs))
    one = whole(_t(o), _t(d), TMIN, float("inf"))
    assert torch.equal(one.t, rec.t) and torch.equal(one.tri, rec.tri)


def test_overflow_retraces_where_jax_loses_pairs(soup, monkeypatch):
    """With the capacities shrunk to one tile a level (128-ray segments:
    one compilation of each JAX kernel for every level), JAX's tracer
    reports lost pairs and loses hits; the port traces the segments again
    with what the levels reported they need and returns every hit."""
    o, d = _soup_rays(1)
    ref = bf.make_bf_tracer(*(_t(x) for x in soup))[0](
        _t(o), _t(d), TMIN, float("inf"))
    for mod in (jbf, bf):
        monkeypatch.setattr(mod, "PAIR_CAP_MULT", (1.0,) * 10)
        monkeypatch.setattr(mod, "CAP_SLACK_TILES", 0)
    tc, _ = bf.make_bf_tracer(*(_t(x) for x in soup), seg_rays=LANES)
    jc, _ = jbf.make_bf_tracer(*soup, seg_rays=LANES)
    jrec, jovf = jc.with_overflow(o, d, TMIN, 1e30, None)
    assert int(jovf) > 0
    assert int(np.asarray(jrec.hit).sum()) < int(ref.hit.sum())
    rec, segs = tc.with_levels(_t(o), _t(d), TMIN, float("inf"))
    assert len(segs) == 8
    assert all(s["traces"] > 1 and s["caps"][1] > 1 for s in segs)
    assert all(int(s["stat"][1:, bf.LOST].sum()) == 0 for s in segs)
    for a, b in ((rec.t, ref.t), (rec.tri, ref.tri), (rec.bary, ref.bary)):
        assert torch.equal(a, b)
    assert tc.with_overflow(_t(o), _t(d), TMIN, float("inf"))[1] == 0


def test_tree_helpers_and_refusals(soup):
    nodes, blocks, meta, slot = soup
    assert bf._tree_depth(meta) == jbf._tree_depth(meta)
    assert bf._all_leaves_single_block(meta, blocks.shape[0])
    multi, _ = _build(*_random_soup(t=600, seed=3), leaf_cap=31 * 8)
    args = (multi.nodes, multi.tri_blocks, multi.meta)
    assert (bf._all_leaves_single_block(multi.meta, args[1].shape[0])
            == jbf._all_leaves_single_block(multi.meta, args[1].shape[0])
            is False)
    with pytest.raises(ValueError, match="single-block leaves"):
        bf.make_bf_tracer(*(_t(x) for x in args))
    for tier in ("two_phase", "low"):
        with pytest.raises(ValueError, match="unknown mt_precision"):
            bf.make_bf_tracer(*(_t(x) for x in soup), mt_precision=tier)
    # an instanced tree's leaf tags decode to block ids out of range
    tagged = meta.copy()
    leaf = np.nonzero(tagged <= -2)[0][0]
    tagged[leaf] = -((-tagged[leaf] - 2) | (3 << 19)) - 2
    assert not bf._all_leaves_single_block(tagged, blocks.shape[0])
    assert not jbf._all_leaves_single_block(tagged, blocks.shape[0])


def test_wrappers_dispatch_by_device(soup):
    """CPU tensors run the plain versions; other devices are refused; an
    empty wave traces nothing."""
    nodes = _t(soup[0]).reshape(-1, 16, 8)
    units = torch.zeros(2, dtype=torch.int32)
    level = torch.tensor([2, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    pairs = torch.arange(256, dtype=torch.int32).view(2, LANES)
    o, d = _soup_rays(1, 256)
    rays = torch.cat([_t(o).T, _t(d).T, torch.full((1, 256), TMIN),
                      torch.full((1, 256), 1e30)]).contiguous()
    got = bf.bf_expand(units, level, pairs, rays, nodes)
    ref = bf.bf_expand_plain(units, level, pairs, rays, nodes)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="unsupported device"):
        bf.bf_expand(units.to("meta"), level.to("meta"), pairs.to("meta"),
                     rays.to("meta"), nodes.to("meta"))
    tc, ta = bf.make_bf_tracer(*(_t(x) for x in soup))
    z = torch.zeros((0, 3))
    assert tc(z, z, TMIN, float("inf")).bary.shape == (0, 2)
    assert ta(z, z, TMIN, TMAX_ANY).shape == (0,)


SMALL = dict(sphere_res=(12, 16))    # the small colonnade of the slice tests


def _colonnade_flat(**kw):
    scene, cam = jcolonnade(**SMALL)
    return jflatten(scene, cam, JSettings(tracer="bf", instancing="off",
                                          **kw))


def test_render_step_matches_jax():
    """tests/test_bfstream.py:117-153's render, tracer="bf" on both sides
    through render_step, on the small colonnade (the spheres scene there
    is textured, and textures are not ported); the port's flat is JAX's,
    carried across."""
    kw = dict(width=16, height=16, spp=2, max_bounces=3, sampler="pcg4d")
    jflat = _colonnade_flat(width=16, height=16)
    depth = jbf._tree_depth(np.asarray(jflat.wbvh_meta))
    jset = JSettings(tracer="bf", instancing="off", bf_depth=depth, **kw)
    ref = np.asarray(jintegrator.render_step(
        jflat, jset, jnp.zeros((256, 3)), jnp.int32(0),
        features=janalyze(jflat)))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    settings = RenderSettings(tracer="bf", instancing="off", bf_depth=depth,
                              **kw)
    before = dict(bf.LAUNCHES)
    img = integrator.render_step(flat, settings, torch.zeros((256, 3)), 0,
                                 features=analyze_features(flat)).numpy()
    assert bf.LAUNCHES == before
    assert np.isfinite(img).all() and img.mean() > 0
    assert np.abs(img - ref).max() < 1e-4, np.abs(img - ref).max()


def test_renderer_fills_bf_depth():
    scene, cam = make_colonnade_scene(**SMALL)
    r = Renderer(scene, device="cpu")
    r.start_render(cam, RenderSettings(width=8, height=8, spp=1,
                                       max_bounces=2, tracer="bf",
                                       instancing="off"))
    assert r.settings.bf_depth == bf._tree_depth(
        r.flat.wbvh_meta.numpy()) >= 1
    r.render()
    assert np.isfinite(r.readback()).all()


def test_make_tracers_refusals():
    flat = flat_from_numpy(jax.tree.map(np.asarray, _colonnade_flat(
        width=8, height=8)), "cpu")
    with pytest.raises(ValueError, match="unknown mt_precision"):
        integrator.make_tracers(flat, RenderSettings(
            tracer="bf", mt_precision="two_phase"))
    iscene, icam = instanced_scene("platinum_tpu")
    iflat = flat_from_numpy(jax.tree.map(np.asarray, jflatten(
        iscene, icam, JSettings(width=8, height=8, instancing="on"))), "cpu")
    assert iflat.instances is not None
    with pytest.raises(ValueError, match="plain resident tree"):
        integrator.make_tracers(iflat, RenderSettings(tracer="bf"))
    # any-hit waves take the packet tracer
    tc, ta = integrator.make_tracers(flat, RenderSettings(tracer="bf"))
    assert tc.__qualname__.startswith("make_bf_tracer")
    assert ta.__qualname__.startswith("make_packet_tracer")


def test_cornell_without_a_wide_bvh_renders_with_the_brute_tracer():
    """tracer="bf" on a scene below accel_min_tris: JAX's make_tracers
    falls through to the brute tracer (integrator.py:106-111), and so does
    the port's; the renders agree."""
    scene, cam = jcornell()
    kw = dict(width=8, height=8, spp=1, max_bounces=2, tracer="bf")
    jflat = jflatten(scene, cam, JSettings(**kw))
    assert jflat.wbvh_nodes is None
    ref = np.asarray(jintegrator.render_step(
        jflat, JSettings(**kw), jnp.zeros((64, 3)), jnp.int32(0),
        features=janalyze(jflat)))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    tc, _ = integrator.make_tracers(flat, RenderSettings(**kw))
    assert tc.__qualname__.startswith("make_brute_tracer")
    img = integrator.render_step(flat, RenderSettings(**kw),
                                 torch.zeros((64, 3)), 0,
                                 features=analyze_features(flat)).numpy()
    np.testing.assert_allclose(img, ref, rtol=2e-3, atol=2e-3)
