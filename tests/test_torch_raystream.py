"""The port's breadth-first ray-stream tracer and its leaf-pair kernel
(K15) against the JAX package's ops/raystream.py, on the CPU.

Inputs come from a numpy seed: the random soup of
tests/test_pallas_trace.py and the small colonnade. The JAX side runs its
Pallas MT kernel in interpret mode (it refuses every backend but the CPU);
the port runs `stream_mt_plain`, as `stream_mt` does for CPU tensors.
Bars: hit sets, triangle ids and occlusion equal; t bit for bit at
"highest" on the whole tracer (both sides reduce the same per-pair
minima; where the summation order of a dot differs, t is held to rtol
1e-5 / atol 1e-6 as in tests/test_torch_trace.py), to the same bar at
"high".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_colonnade_scene
from platinum_tpu.ops import raystream as jrs
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.ops import raystream as rs
from test_pallas_trace import _build, _random_soup

torch.set_num_threads(1)
R = 1024
TMIN, TMAX_ANY = 1e-3, 8.0
T_RTOL, T_ATOL = 1e-5, 1e-6


def _rays(seed, r=R):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def soup():
    wide, _ = _build(*_random_soup(t=500, seed=11), leaf_cap=16)
    return wide


def _port(wide, **kw):
    return rs.make_stream_tracer(
        _t(wide.nodes), _t(wide.tri_blocks), _t(wide.meta),
        _t(wide.tri_of_slot.astype(np.int32)), **kw)


def _jax(wide, **kw):
    return jrs.make_stream_tracer(wide.nodes, wide.tri_blocks, wide.meta,
                                  wide.tri_of_slot, **kw)


@pytest.fixture(scope="module")
def jax_soup(soup):
    """JAX's tracer on the soup, jitted once with per-ray tmax and an
    active mask as arguments, so every test reuses one compilation."""
    jc, ja = _jax(soup)
    return (jax.jit(lambda o, d, tmax, act: jc(o, d, TMIN, tmax, act)),
            jax.jit(lambda o, d, tmax, act: ja(o, d, TMIN, tmax, act)))


def _hold(rec, jrec, bitwise):
    hit = np.asarray(jrec.hit)
    assert np.array_equal(rec.hit.numpy(), hit)
    assert np.array_equal(rec.tri.numpy(), np.asarray(jrec.tri))
    t, jt = rec.t.numpy(), np.asarray(jrec.t)
    if bitwise:
        assert np.array_equal(t.view(np.int32), jt.view(np.int32))
    else:
        np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_allclose(rec.bary.numpy(), np.asarray(jrec.bary),
                               rtol=1e-4, atol=1e-5)
    return int(hit.sum())


def test_stream_tracer_matches_jax_on_the_soup(soup, jax_soup):
    """Hit, triangle and occlusion equal, t bit for bit at "highest"; and
    the port's own packet tracer (K1/K2's plain version) agrees."""
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    full = np.ones(R, bool)
    jrec = jax_soup[0](oc, dc, np.full(R, np.inf, np.float32), full)
    jocc = jax_soup[1](oa, da, np.full(R, TMAX_ANY, np.float32), full)
    tc, ta = _port(soup)
    before = dict(rs.LAUNCHES)
    rec = tc(_t(oc), _t(dc), TMIN, float("inf"))
    occ = ta(_t(oa), _t(da), TMIN, TMAX_ANY)
    assert rs.LAUNCHES == before    # CPU tensors never reach the kernel
    assert _hold(rec, jrec, bitwise=True) > 100
    assert np.array_equal(occ.numpy(), np.asarray(jocc)) and occ.sum() > 50
    pc, pa = pt.make_packet_tracer(
        _t(soup.nodes), _t(soup.tri_blocks), _t(soup.meta),
        _t(soup.tri_of_slot.astype(np.int32)))
    k1 = pc(_t(oc), _t(dc), TMIN, float("inf"))
    assert torch.equal(rec.hit, k1.hit) and torch.equal(rec.tri, k1.tri)
    torch.testing.assert_close(rec.t[k1.hit], k1.t[k1.hit], rtol=T_RTOL,
                               atol=T_ATOL)
    assert torch.equal(occ, pa(_t(oa), _t(da), TMIN, TMAX_ANY))


def test_stream_tracer_active_masks_and_per_ray_tmax(soup, jax_soup):
    o, d = _rays(7)
    rng = np.random.default_rng(8)
    act = rng.random(R) < 0.5
    tmax = rng.uniform(2.0, 16.0, R).astype(np.float32)
    jrec = jax_soup[0](o, d, tmax, act)
    jocc = jax_soup[1](o, d, tmax, act)
    tc, ta = _port(soup)
    rec = tc(_t(o), _t(d), TMIN, _t(tmax), active=_t(act))
    occ = ta(_t(o), _t(d), TMIN, _t(tmax), active=_t(act))
    assert _hold(rec, jrec, bitwise=True) > 30
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert not rec.hit[~_t(act)].any() and not occ[~_t(act)].any()
    # a limited ray hits nothing beyond its tmax
    assert (rec.t[rec.hit] < _t(tmax)[rec.hit]).all()


def test_stream_tracer_high_tier_matches_jax(soup):
    """ "high" (bf16x3): both sides split the same operands; hits, ids
    and occlusion equal, t to the bar (the order of the fp32 sums
    differs)."""
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    jc, ja = _jax(soup, mt_precision="high")
    jrec = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(oc, dc)
    jocc = jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(oa, da)
    tc, ta = _port(soup, mt_precision="high")
    rec = tc(_t(oc), _t(dc), TMIN, float("inf"))
    assert _hold(rec, jrec, bitwise=False) > 100
    assert np.array_equal(ta(_t(oa), _t(da), TMIN, TMAX_ANY).numpy(),
                          np.asarray(jocc))
    # the tier is not fp32: t moves off the "highest" t on most hits
    base = _port(soup)[0](_t(oc), _t(dc), TMIN, float("inf"))
    same = base.hit & (base.tri == rec.tri)
    moved = (rec.t[same].view(torch.int32)
             != base.t[same].view(torch.int32)).float().mean()
    assert moved > 0.5


def _one_level_pairs(wide, any_hit):
    """The leaf pairs of the level with the most of them, as the port's
    tracer hands them to `stream_mt`."""
    calls = []

    def capture(rays, limit, pair_ray, pair_block, blocks, ah, prec):
        calls.append((rays, limit, pair_ray, pair_block))
        return rs.stream_mt_plain(rays, limit, pair_ray, pair_block, blocks,
                                  ah, prec)

    o, d = _rays(5)
    pair = _port(wide, mt_fn=capture)
    if any_hit:
        pair[1](_t(o), _t(d), TMIN, TMAX_ANY)
    else:
        pair[0](_t(o), _t(d), TMIN, float("inf"))
    return max(calls, key=lambda c: c[2].shape[0])


def _bf16_np(x):
    """float32 -> nearest-even bf16 -> float32, in numpy."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_stream_mt_plain_matches_the_jax_kernel(soup, tier, any_hit):
    """`stream_mt_plain` against the JAX kernel `_build_mt_call(...)` in
    interpret mode on one level's real pairs (padded with block id -1 to
    whole grid steps, as the JAX tracer pads). "default" is held to a
    numpy model of the 1-pass bf16 product instead: XLA:CPU ignores
    Precision.DEFAULT, so the JAX kernel computes "highest" there."""
    rays, limit, pair_ray, pair_block = _one_level_pairs(soup, any_hit)
    n = pair_ray.shape[0]
    assert n > 500
    t, slot, u, v = rs.stream_mt_plain(rays, limit, pair_ray, pair_block,
                                       _t(soup.tri_blocks), any_hit, tier)
    rn, pr, pb = rays.numpy(), pair_ray.numpy(), pair_block.numpy()
    o, d = rn[0:3].T, rn[3:6].T
    feat = np.concatenate([d, np.cross(o, d), o,
                           np.ones((o.shape[0], 1), np.float32)], 1)
    if tier == "default":
        coef = _bf16_np(soup.tri_blocks[pb])              # (n, 10, 256)
        out = np.einsum("nkm,nk->nm", coef, _bf16_np(feat[pr]),
                        dtype=np.float32).reshape(n, 4, 64)
        s = np.where(out[:, 0] >= 0, 1.0, -1.0).astype(np.float32)
        ad, us, vs, ts = (out[:, q] * s for q in range(4))
        lo, hi = rn[6, pr][:, None], limit.numpy()[pr][:, None]
        with np.errstate(invalid="ignore"):      # inf * 0 on a zero det
            ok = ((ad > 1e-12) & (us >= 0) & (vs >= 0) & (us + vs <= ad)
                  & (ts > lo * ad) & (ts < hi * ad))
        if any_hit:
            assert (ok.any(1) == (slot.numpy() > 0)).mean() > 0.995
            return
        t_ref = np.where(ok, ts / np.maximum(ad, 1e-37), np.inf).min(1)
        hit = np.isfinite(t_ref)
        assert (hit == (slot.numpy() >= 0)).mean() > 0.995
        both = hit & (slot.numpy() >= 0)
        np.testing.assert_allclose(t.numpy()[both], t_ref[both],
                                   rtol=T_RTOL, atol=T_ATOL)
        return
    step = jrs.LANES * jrs.MT_CHUNKS_PER_STEP
    g = -(-n // step)
    pad = g * step - n
    bid = np.concatenate([pb, np.full(pad, -1, np.int32)])
    ray = np.concatenate([pr, np.zeros(pad, np.int32)])
    feat16 = np.zeros((g * step, 16), np.float32)
    feat16[:, :10] = feat[ray]
    lims = np.stack([rn[6, ray], limit.numpy()[ray]], 1)
    shape = (g, jrs.MT_CHUNKS_PER_STEP, jrs.LANES)
    call = jrs._build_mt_call(g, soup.tri_blocks.shape[0], any_hit, True,
                              tier)
    jt, js, ju, jv = (np.asarray(x).reshape(-1)[:n] for x in call(
        jnp.asarray(bid.reshape(shape)),
        jnp.asarray(feat16.reshape(*shape, 16).transpose(0, 1, 3, 2)),
        jnp.asarray(lims.reshape(*shape, 2).transpose(0, 1, 3, 2)),
        jnp.asarray(soup.tri_blocks)))
    if any_hit:
        assert np.array_equal(slot.numpy() > 0, js > 0) and (js > 0).any()
        return
    hit = js >= 0
    assert np.array_equal(slot.numpy(), js.astype(np.int32))
    assert hit.sum() > 50 and np.isinf(t.numpy()[~hit]).all()
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=T_RTOL,
                               atol=T_ATOL)
    np.testing.assert_allclose(u.numpy()[hit], ju[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], jv[hit], rtol=1e-4, atol=1e-5)


def test_stream_mt_padding_pairs_miss(soup):
    rays, limit, pair_ray, pair_block = _one_level_pairs(soup, False)
    pb = pair_block.clone()
    pb[::3] = -1
    t, slot, u, v = rs.stream_mt(rays, limit, pair_ray, pb,
                                 _t(soup.tri_blocks), False)
    assert torch.isinf(t[::3]).all() and (slot[::3] == -1).all()
    full = rs.stream_mt_plain(rays, limit, pair_ray, pair_block,
                              _t(soup.tri_blocks), False)
    keep = pb >= 0
    assert torch.equal(t[keep], full[0][keep])
    assert torch.equal(slot[keep], full[1][keep])
    empty = rs.stream_mt(rays, limit, pair_ray[:0], pair_block[:0],
                         _t(soup.tri_blocks), True)
    assert all(x.shape == (0,) for x in empty)


def test_stream_tracer_on_the_small_colonnade():
    """The scene the render tests use: camera-like rays from outside and
    shadow-like segments, against the JAX tracer."""
    scene, cam = make_colonnade_scene(sphere_res=(12, 16))
    jflat = jflatten(scene, cam, JSettings(width=16, height=16,
                                           tracer="packet",
                                           instancing="off"))
    arrs = [np.asarray(x) for x in (jflat.wbvh_nodes, jflat.wbvh_tris,
                                    jflat.wbvh_meta, jflat.wbvh_slot)]
    jc, ja = jrs.make_stream_tracer(*arrs)
    tc, ta = rs.make_stream_tracer(*(_t(x) for x in arrs))
    rng = np.random.default_rng(12)
    lo = arrs[0].reshape(-1, 16, 8)[0, :, 0:3].min(0)
    hi = arrs[0].reshape(-1, 16, 8)[0, :, 3:6].max(0)
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(0, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jrec = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(o, d)
    jocc = jax.jit(lambda o, d: ja(o, d, TMIN, 3.0))(o, d)
    rec, levels_c = tc.with_levels(_t(o), _t(d), TMIN, float("inf"))
    occ, levels_a = ta.with_levels(_t(o), _t(d), TMIN, 3.0)
    assert _hold(rec, jrec, bitwise=True) > 300
    assert np.array_equal(occ.numpy(), np.asarray(jocc)) and occ.sum() > 50
    # one entry per level, the root level holding every ray
    for levels in (levels_c, levels_a):
        assert levels[0]["pairs"] == R
        assert [s["level"] for s in levels] == list(range(len(levels)))
    assert sum(s["leaf_pairs"] for s in levels_c) > R
    assert sum(s["leaf_pairs"] for s in levels_a) > 0


def test_with_overflow_never_overflows(soup):
    """The JAX module drops pairs beyond its static caps and counts them;
    the port sizes every list exactly, so the count is 0 where the JAX
    module's is, with the same results."""
    o, d = _rays(5)
    jc, _ = _jax(soup)
    jrec, jovf = jax.jit(lambda o, d: jc.with_overflow(
        o, d, TMIN, jnp.inf, None))(o, d)
    tc, ta = _port(soup)
    rec, ovf = tc.with_overflow(_t(o), _t(d), TMIN, float("inf"), None)
    assert int(jovf) == 0 and int(ovf) == 0
    _hold(rec, jrec, bitwise=True)
    occ, ovf = ta.with_overflow(_t(o), _t(d), TMIN, TMAX_ANY, None)
    assert int(ovf) == 0 and occ.dtype == torch.bool


def test_tree_helpers_match_jax(soup):
    assert rs._tree_depth(soup.meta) == jrs._tree_depth(soup.meta) >= 1
    assert rs._all_leaves_single_block(soup.meta)
    wide, _ = _build(*_random_soup(t=600, seed=3), leaf_cap=31 * 8)
    assert rs._tree_depth(wide.meta) == jrs._tree_depth(wide.meta)
    assert (rs._all_leaves_single_block(wide.meta)
            == jrs._all_leaves_single_block(wide.meta) is False)
    looped = soup.meta.copy()
    looped[np.nonzero(looped >= 0)[0][0]] = 0      # a child that is the root
    with pytest.raises(ValueError, match="cycle"):
        rs._tree_depth(looped)


def test_multi_block_leaves_and_unknown_tiers_raise(soup):
    wide, _ = _build(*_random_soup(t=600, seed=3), leaf_cap=31 * 8)
    with pytest.raises(ValueError, match="single-block leaves"):
        _port(wide)
    for tier in ("two_phase", "low"):
        with pytest.raises(ValueError, match="unknown mt_precision"):
            _port(soup, mt_precision=tier)


def test_stream_mt_dispatch_by_device(soup):
    """CPU tensors run the plain version; other devices are refused (a
    CUDA tensor launches the kernel or raises)."""
    rays, limit, pair_ray, pair_block = _one_level_pairs(soup, False)
    blocks = _t(soup.tri_blocks)
    got = rs.stream_mt(rays, limit, pair_ray, pair_block, blocks, False)
    ref = rs.stream_mt_plain(rays, limit, pair_ray, pair_block, blocks, False)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="unsupported device"):
        rs.stream_mt(rays.to("meta"), limit.to("meta"), pair_ray.to("meta"),
                     pair_block.to("meta"), blocks.to("meta"), False)
