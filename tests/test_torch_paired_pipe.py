"""The paired launch (K8), the pipelined walk (K9) and the ablation modes
of the port's packet tracer against the JAX package's, on the CPU.

Inputs come from a numpy seed (the random soup of tests/test_pallas_trace.py
at 500 triangles, its line 167). The JAX tracers run their Pallas kernels
in interpret mode, one packet per step and one pop per superstep (the same
contract, a fraction of the compile time), each built once per module; the
port runs its plain versions, as it does for CPU tensors. Bars, as
tests/test_torch_trace.py states them: hit sets, triangle ids and
occlusion equal; t to rtol 1e-5 / atol 1e-6 (the JAX side accumulates its
dots in another order than the plain version's matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops.pallas_trace import make_packet_tracer as jpacket
from platinum_tpu_torch.ops import packet_trace as pt
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


@pytest.fixture(scope="module")
def soup():
    wide, _ = _build(*_random_soup(t=500, seed=11), leaf_cap=16)
    return wide


def _jax_pair(wide, **kw):
    return jpacket(wide.nodes, wide.tri_blocks, wide.meta, wide.tri_of_slot,
                   pops=1, **{"packets": 1, **kw})


def _port_pair(wide, **kw):
    return pt.make_packet_tracer(
        torch.from_numpy(wide.nodes), torch.from_numpy(wide.tri_blocks),
        torch.from_numpy(wide.meta),
        torch.from_numpy(wide.tri_of_slot.astype(np.int32)), **kw)


@pytest.fixture(scope="module")
def jax_base(soup):
    """JAX's K1/K2 results on the two waves every test here traces."""
    jc, ja = _jax_pair(soup)
    oc, dc = _rays(5)
    oa, da = _rays(6)
    rec = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(oc, dc)
    occ = jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(oa, da)
    return rec, np.asarray(occ)


def _hold_closest(rec, ref):
    hit = np.asarray(ref.hit)
    assert np.array_equal(rec.hit.numpy(), hit) and hit.sum() > 100
    assert np.array_equal(rec.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(rec.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=T_RTOL, atol=T_ATOL)


def _same_record(a, b):
    for name in ("t", "tri", "bary", "hit"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("n_any", [R, R // 2])
def test_paired_matches_jax_paired_and_own_tracers(soup, jax_base, n_any):
    """Equal and unequal wave lengths: the port's paired launch against
    JAX's `trace_closest.paired` (two packets per step, one per mode) and
    against the port's own trace_closest / trace_any, which it must equal
    exactly: the same walks."""
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    oa, da = oa[:n_any], da[:n_any]
    jc, _ = _jax_pair(soup, packets=2)
    jrec, jocc = jax.jit(lambda a, b, c, d: jc.paired(
        a, b, TMIN, jnp.inf, c, d, TMIN, TMAX_ANY))(oc, dc, oa, da)
    # JAX's paired launch is its own K1/K2
    assert np.array_equal(np.asarray(jrec.tri), np.asarray(jax_base[0].tri))
    assert np.array_equal(np.asarray(jocc), jax_base[1][:n_any])

    tc, ta = _port_pair(soup)
    before = dict(pt.LAUNCHES)
    rec, occ = tc.paired(_t(oc), _t(dc), TMIN, float("inf"),
                         _t(oa), _t(da), TMIN, TMAX_ANY)
    assert pt.LAUNCHES == before    # CPU tensors never reach the kernel
    _hold_closest(rec, jrec)
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    _same_record(rec, tc(_t(oc), _t(dc), TMIN, float("inf")))
    assert torch.equal(occ, ta(_t(oa), _t(da), TMIN, TMAX_ANY))


@pytest.mark.parametrize("empty", ["closest", "any"])
def test_paired_with_one_wave_empty(soup, empty):
    tc, ta = _port_pair(soup)
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    if empty == "closest":
        oc, dc = oc[:0], dc[:0]
    else:
        oa, da = oa[:0], da[:0]
    rec, occ = tc.paired(_t(oc), _t(dc), TMIN, float("inf"),
                         _t(oa), _t(da), TMIN, TMAX_ANY)
    assert rec.hit.shape == (oc.shape[0],) and occ.shape == (oa.shape[0],)
    if empty == "any":
        _same_record(rec, tc(_t(oc), _t(dc), TMIN, float("inf")))
    else:
        assert torch.equal(occ, ta(_t(oa), _t(da), TMIN, TMAX_ANY))


@pytest.mark.parametrize("tier", ["highest", "high"])
def test_paired_sorts_masks_and_unsorts_each_wave_by_itself(soup, tier):
    """Waves long enough to be sorted (octant + Morton), of unequal
    length, with active masks and a per-ray tmax on the shadow wave: each
    wave comes back in its own order, equal to the unpaired traces; the
    closest wave honours the tier."""
    tc, ta = _port_pair(soup, sort=True, mt_precision=tier)
    (oc, dc), (oa, da) = _rays(7, 2048), _rays(8, 1536)
    rng = np.random.default_rng(9)
    act_c = _t(rng.random(2048) < 0.6)
    act_a = _t(rng.random(1536) < 0.7)
    tmax_a = _t(rng.uniform(1.0, 9.0, 1536).astype(np.float32))
    rec, occ = tc.paired(_t(oc), _t(dc), TMIN, float("inf"), _t(oa), _t(da),
                         TMIN, tmax_a, active_c=act_c, active_a=act_a)
    _same_record(rec, tc(_t(oc), _t(dc), TMIN, float("inf"), active=act_c))
    assert torch.equal(occ, ta(_t(oa), _t(da), TMIN, tmax_a, active=act_a))
    assert not rec.hit[~act_c].any() and not occ[~act_a].any()
    assert rec.hit.sum() > 100 and occ.sum() > 50


def test_pair_rays_keeps_the_waves_in_separate_blocks():
    """The any-hit rays start at a multiple of the kernel's block size,
    behind dead padding rays (tmax < tmin)."""
    rc = torch.arange(8 * 300, dtype=torch.float32).reshape(8, 300)
    ra = -torch.arange(8 * 50, dtype=torch.float32).reshape(8, 50)
    rays, n_split = pt.pair_rays(rc, ra)
    assert n_split == 384 and n_split % pt.PAIR_ALIGN == 0
    assert rays.shape == (8, 434) and rays.is_contiguous()
    assert torch.equal(rays[:, :300], rc) and torch.equal(rays[:, 384:], ra)
    assert (rays[7, 300:384] < rays[6, 300:384]).all()
    rays, n_split = pt.pair_rays(rc[:, :256], ra)
    assert n_split == 256 and rays.shape == (8, 306)


def test_paired_on_an_instanced_tree_raises():
    from instanced_scenes import instanced_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = instanced_scene("platinum_tpu_torch")
    flat = flatten_scene(scene, cam, RenderSettings(
        width=8, height=8, instancing="on", tracer="packet"),
        accel_min_tris=1, device="cpu")
    tc, _ = pt.make_packet_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                                  flat.wbvh_meta, flat.wbvh_slot,
                                  inst_feat=flat.instances.feat)
    o, d = (_t(x) for x in _rays(1, 64))
    with pytest.raises(ValueError, match="non-instanced only"):
        tc.paired(o, d, TMIN, float("inf"), o, d, TMIN, TMAX_ANY)


@pytest.mark.parametrize("walk", ["pipe", "flat_walk"])
def test_pipelined_walk_matches_jax(soup, jax_base, walk):
    """`pipe=True` and `flat_walk=True` (which implies it): the port's
    plain version against JAX's `_make_kernel_pipe`; JAX's pipelined
    walk is bit for bit its own K1/K2 here, and the port's plain version
    is K1's by construction (the walk changes no result)."""
    jc, ja = _jax_pair(soup, **{walk: True})
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    jrec = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(oc, dc)
    jocc = np.asarray(jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(oa, da))
    assert np.array_equal(np.asarray(jrec.t).view(np.int32),
                          np.asarray(jax_base[0].t).view(np.int32))
    assert np.array_equal(jocc, jax_base[1])

    tc, ta = _port_pair(soup, **{walk: True})
    rec = tc(_t(oc), _t(dc), TMIN, float("inf"))
    _hold_closest(rec, jrec)
    assert np.array_equal(ta(_t(oa), _t(da), TMIN, TMAX_ANY).numpy(), jocc)
    k1, _ = _port_pair(soup)
    _same_record(rec, k1(_t(oc), _t(dc), TMIN, float("inf")))


def test_pipe_defaults_follow_the_module_constants(soup, monkeypatch):
    """`profile=None` takes PROFILE, as in the JAX package
    (pallas_trace.py:1191-1193); the pipelined walk is off unless asked
    for, and the flat push tells the wrapper that the tracer has checked
    the tree's leaves."""
    seen = {}

    def spy(rays, nodes, blocks, meta, any_hit, inst_feat, **kw):
        seen.update(kw)
        return pt.trace_wide_reference(rays, nodes, blocks, meta, any_hit,
                                       inst_feat, **kw)

    o, d = (_t(x) for x in _rays(1, 64))
    _port_pair(soup, trace_fn=spy)[0](o, d, TMIN, float("inf"))
    assert "pipe" not in seen and "profile" not in seen
    _port_pair(soup, trace_fn=spy, pipe=True)[0](o, d, TMIN, float("inf"))
    assert seen["pipe"] is True and seen["flat_walk"] is False
    assert seen["checked"] is False
    _port_pair(soup, trace_fn=spy, flat_walk=True)[0](o, d, TMIN,
                                                      float("inf"))
    assert seen["pipe"] is True and seen["flat_walk"] is seen["checked"] is True
    monkeypatch.setattr(pt, "PROFILE", "nomt")
    seen.clear()
    rec = _port_pair(soup, trace_fn=spy)[0](o, d, TMIN, float("inf"))
    assert seen["profile"] == "nomt" and not rec.hit.any()


def _multi_block_tree():
    wide, _ = _build(*_random_soup(t=600, seed=3), leaf_cap=31 * 8)
    assert (((-wide.meta[wide.meta <= -2] - 2) & 31) > 1).any()
    return wide


REFUSALS = {
    "pipe+stream": (dict(pipe=True, stream=True), "default walk"),
    "flat_walk+stream": (dict(flat_walk=True, stream=True), "default walk"),
    "pipe+two_phase": (dict(pipe=True, mt_precision="two_phase"), "fp32"),
    "pipe+high": (dict(pipe=True, mt_precision="high"), "fp32"),
    "flat_walk+default": (dict(flat_walk=True, mt_precision="default"),
                          "fp32"),
    "pipe+profile": (dict(pipe=True, profile="nomt"), "no profile"),
    "profile+stream": (dict(profile="empty", stream=True), "classic"),
    "unknown profile": (dict(profile="half"), "unknown profile"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_mode_that_cannot_run_raises(soup, name):
    """What the JAX package refuses (pallas_trace.py:1196-1203), and the
    reduced tier it silently drops under `pipe`."""
    kw, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        _port_pair(soup, **kw)


def test_flat_walk_over_a_multi_block_leaf_raises():
    wide = _multi_block_tree()
    with pytest.raises(ValueError, match="exactly one MT block"):
        _port_pair(wide, flat_walk=True)
    nodes = _t(wide.nodes).reshape(-1, 16, 8)
    o, d = _rays(1, 64)
    rays = torch.cat([_t(o).T, _t(d).T, torch.full((1, 64), TMIN),
                      torch.full((1, 64), float("inf"))]).contiguous()
    with pytest.raises(ValueError, match="exactly one MT block"):
        pt.trace_wide(rays, nodes, _t(wide.tri_blocks), _t(wide.meta), False,
                      flat_walk=True)
    # the pipelined walk without the flat push takes such a tree
    rec = _port_pair(wide, pipe=True)[0](_t(o), _t(d), TMIN, float("inf"))
    _same_record(rec, _port_pair(wide)[0](_t(o), _t(d), TMIN, float("inf")))


@pytest.mark.parametrize("profile", ["empty", "nomt"])
def test_profiles_that_test_no_triangle_miss_everything(soup, profile):
    tc, ta = _port_pair(soup, profile=profile)
    (oc, dc), (oa, da) = _rays(5), _rays(6)
    rec = tc(_t(oc), _t(dc), TMIN, float("inf"))
    assert not rec.hit.any() and (rec.tri == -1).all()
    assert torch.isinf(rec.t).all() and not rec.bary.any()
    assert not ta(_t(oa), _t(da), TMIN, TMAX_ANY).any()


def test_profile_count_keeps_t_and_ids(soup, jax_base):
    """`profile="count"`: t, id and v are the walk's own (here K1's plain
    version's, and JAX's `profile="count"` t / tri); u carries the
    iteration count, which a brute force does not have (0)."""
    oc, dc = _rays(5)
    jc, _ = _jax_pair(soup, profile="count")
    jrec = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(oc, dc)
    assert np.array_equal(np.asarray(jrec.tri), np.asarray(jax_base[0].tri))
    rec = _port_pair(soup, profile="count")[0](_t(oc), _t(dc), TMIN,
                                               float("inf"))
    _hold_closest(rec, jrec)
    k1 = _port_pair(soup)[0](_t(oc), _t(dc), TMIN, float("inf"))
    assert torch.equal(rec.t, k1.t) and torch.equal(rec.tri, k1.tri)
    assert torch.equal(rec.bary[:, 1], k1.bary[:, 1])
    assert not rec.bary[:, 0].any()


def test_profile_fix64_returns_a_record(soup):
    """Timed only: whatever it returns has the walk's shapes and types."""
    oc, dc = _rays(5)
    rec = _port_pair(soup, profile="fix64")[0](_t(oc), _t(dc), TMIN,
                                               float("inf"))
    assert rec.t.shape == (R,) and rec.tri.dtype == torch.int32


def test_launch_keys_name_every_new_mode_once():
    keys = [pt.launch_key(False, paired=True),
            pt.launch_key(False, paired=True, stream=True),
            pt.launch_key(False, paired=True, mt_precision="two_phase"),
            pt.launch_key(False, pipe=True), pt.launch_key(True, pipe=True),
            pt.launch_key(False, True, pipe=True),
            pt.launch_key(False, pipe=True, flat_walk=True),
            pt.launch_key(True, True, pipe=True, flat_walk=True),
            pt.launch_key(False, profile="empty"),
            pt.launch_key(True, profile="nomt"),
            pt.launch_key(False, stream=True, profile="nomt"),
            pt.launch_key(False, profile="fix64"),
            pt.launch_key(True, profile="count")]
    assert len(set(keys)) == len(keys)
    assert all(k in pt.LAUNCHES for k in keys)
    assert "closest" in pt.LAUNCHES and "stream+any" in pt.LAUNCHES
