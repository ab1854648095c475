"""platinum_tpu_torch tracers vs the JAX package's on the random-soup recipe
of tests/test_pallas_trace.py, with its bars: the port's packet tracer (the
kernel's plain version on CPU tensors) against JAX's make_packet_tracer
(Pallas interpret mode on CPU), and the port's brute tracer against JAX's."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops.intersect import HitRecord as JHitRecord
from platinum_tpu.ops.intersect import fold_closest as jfold
from platinum_tpu.ops.intersect import make_brute_tracer as jbrute
from platinum_tpu.ops.pallas_trace import make_packet_tracer as jpacket
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.ops.intersect import HitRecord, fold_closest
from platinum_tpu_torch.ops.intersect import make_brute_tracer
from platinum_tpu_torch.render.types import Geometry
from test_pallas_trace import _assert_borderline, _build, _random_soup

torch.set_num_threads(1)
R = 1024 + 64
TMIN, TMAX_ANY = 1e-3, 8.0


def _rays(seed=7, r=R):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _port_geometry(geom):
    return Geometry(**{k: torch.from_numpy(np.array(getattr(geom, k)))
                       for k in ("positions", "normals", "tangents", "uvs",
                                 "indices", "tri_material")})


def _port_packet(wide, **kw):
    return pt.make_packet_tracer(
        torch.from_numpy(wide.nodes), torch.from_numpy(wide.tri_blocks),
        torch.from_numpy(wide.meta),
        torch.from_numpy(wide.tri_of_slot.astype(np.int32)), **kw)


def _hold_to_bars(rec_p, rec_r, occ_p, occ_r, o, d, soup):
    """tests/test_pallas_trace.py:127-152, port (p) vs reference (r)."""
    hp, hr = rec_p.hit.numpy(), np.asarray(rec_r.hit)
    agree = hp == hr
    assert agree.mean() > 0.995, f"hit sets differ: {(~agree).sum()} rays"
    for i in np.nonzero(~agree)[0]:
        _assert_borderline(i, o, d, *soup, TMIN, np.inf, "closest hit/miss")
    both = hp & hr
    assert both.sum() > 100
    tp, tr = rec_p.t.numpy()[both], np.asarray(rec_r.t)[both]
    trip, trir = rec_p.tri.numpy()[both], np.asarray(rec_r.tri)[both]
    tie = ~np.isclose(tp, tr, rtol=1e-5, atol=1e-6)
    assert ((trip == trir) | ~tie).all() and tie.mean() < 0.005
    np.testing.assert_allclose(tp, tr, rtol=1e-4, atol=1e-5)
    occ_p, occ_r = occ_p.numpy(), np.asarray(occ_r)
    assert (occ_p == occ_r).mean() > 0.995
    for i in np.nonzero(occ_p != occ_r)[0]:
        _assert_borderline(i, o, d, *soup, TMIN, TMAX_ANY, "occlusion")


@pytest.mark.parametrize("leaf_cap", [8, 16])
def test_packet_tracer_matches_jax_packet_tracer(leaf_cap):
    soup = _random_soup()
    wide, _ = _build(*soup, leaf_cap=leaf_cap)
    jc, ja = jpacket(wide.nodes, wide.tri_blocks, wide.meta, wide.tri_of_slot)
    tc, ta = _port_packet(wide)
    o, d = _rays()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    rec_r = jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(jo, jd)
    occ_r = jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(jo, jd)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    launches = dict(pt.LAUNCHES)
    _hold_to_bars(tc(to, td, TMIN, float("inf")), rec_r,
                  ta(to, td, TMIN, TMAX_ANY), occ_r, o, d, soup)
    assert pt.LAUNCHES == launches   # CPU tensors never reach the kernel


def test_brute_tracer_matches_jax_brute_tracer():
    soup = _random_soup()
    _, geom = _build(*soup, leaf_cap=16)
    jc, ja = jbrute(geom)
    tc, ta = make_brute_tracer(_port_geometry(geom))
    o, d = _rays()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    _hold_to_bars(tc(to, td, TMIN, float("inf")),
                  jax.jit(lambda o, d: jc(o, d, TMIN, jnp.inf))(jo, jd),
                  ta(to, td, TMIN, TMAX_ANY),
                  jax.jit(lambda o, d: ja(o, d, TMIN, TMAX_ANY))(jo, jd),
                  o, d, soup)


def test_fold_closest_matches_jax():
    """Carried-best fold, ties (equal t) keeping the earlier record."""
    rng = np.random.default_rng(3)
    n = 512

    def record():
        t = rng.choice([1.0, 2.0, 3.0, np.inf], n).astype(np.float32)
        tri = np.where(np.isfinite(t), rng.integers(0, 99, n), -1)
        return dict(t=t, tri=tri.astype(np.int32), hit=np.isfinite(t),
                    bary=rng.random((n, 2), dtype=np.float32))

    a, b = record(), record()
    ref = jfold(JHitRecord(**{k: jnp.asarray(v) for k, v in a.items()}),
                JHitRecord(**{k: jnp.asarray(v) for k, v in b.items()}))
    got = fold_closest(HitRecord(**{k: torch.from_numpy(v) for k, v in a.items()}),
                       HitRecord(**{k: torch.from_numpy(v) for k, v in b.items()}))
    for k in ("t", "tri", "hit", "bary"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)))


def test_packet_tracer_active_mask_and_sorted_waves():
    """Masked rays never hit; active rays match the unmasked trace; a
    sorted wave (octant + Morton order, then unsorted) matches unsorted."""
    soup = _random_soup(t=3000, seed=11)
    wide, _ = _build(*soup, leaf_cap=16)
    tc, _ = _port_packet(wide, sort=True)
    tc_unsorted, _ = _port_packet(wide, sort=False)
    o, d = (torch.from_numpy(x) for x in _rays(seed=5, r=2048))
    active = torch.from_numpy(np.random.default_rng(5).random(2048) < 0.5)
    rec = tc(o, d, TMIN, float("inf"), active=active)
    assert not rec.hit[~active].any()
    full = tc(o, d, TMIN, float("inf"))
    assert torch.equal(rec.tri[active], full.tri[active])
    ref = tc_unsorted(o, d, TMIN, float("inf"))
    assert torch.equal(full.tri, ref.tri) and torch.equal(full.t, ref.t)


def test_wrapper_dispatch_by_device():
    """CPU tensors run the plain version; other devices are refused (a
    CUDA tensor launches the kernel or raises)."""
    soup = _random_soup(t=200, seed=2)
    wide, _ = _build(*soup, leaf_cap=16)
    nodes = torch.from_numpy(wide.nodes).reshape(-1, 16, 8)
    blocks = torch.from_numpy(wide.tri_blocks)
    meta = torch.from_numpy(wide.meta)
    o, d = (torch.from_numpy(x) for x in _rays(r=256))
    rays = torch.cat([o.T, d.T, torch.full((1, 256), TMIN),
                      torch.full((1, 256), float("inf"))]).contiguous()
    for any_hit in (False, True):
        got = pt.trace_wide(rays, nodes, blocks, meta, any_hit)
        ref = pt.trace_wide_plain(rays, nodes, blocks, meta, any_hit,
                                  max_elems=256 * 64)  # other chunking
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.trace_wide(rays.to("meta"), nodes.to("meta"), blocks.to("meta"),
                      meta.to("meta"), False)


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc present: the build is exercised on the GPU")
    with pytest.raises(RuntimeError, match="nvcc"):
        pt.build_kernel()
