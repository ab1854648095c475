"""The port's binary-BVH tracer (`tracer="bvh"`, ops/traverse.py) against
the JAX package's make_bvh_tracer, on the CPU.

Both sides run pure tensor code (JAX's tracer is plain `jnp` in
`while_loop`s, no Pallas). Inputs from numpy seeds: tests/test_bvh.py's
random soup and the small colonnade, each BVH built by its own package's
builder (the copies are bitwise the originals, tests/test_torch_guard.py).
Bars: hit sets and occlusion equal; triangle ids equal except on exact-t
ties, each certified in float64 (both triangles met inside their edges at
t equal to TIE_RTOL); t within rtol 1e-5 / atol 1e-6
(tests/test_torch_trace.py's bar: XLA:CPU may contract a product and a
sum into one FMA where torch rounds twice). Renders: Cornell with
tracer="bvh" against JAX's per pixel (tests/test_torch_slice.py's bars),
and tracer="auto" on a FlatScene without wide arrays takes this tracer
in both packages.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.accel.bvh import build_bvh as jbuild
from platinum_tpu.app.scenes import make_colonnade_scene as jcolonnade
from platinum_tpu.app.scenes import make_cornell_scene as jcornell
from platinum_tpu.ops import traverse as jtraverse
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.accel.bvh import build_bvh
from platinum_tpu_torch.app.scenes import (make_colonnade_scene,
                                           make_cornell_scene)
from platinum_tpu_torch.ops import traverse
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
T_RTOL, T_ATOL = 1e-5, 1e-6
TIE_RTOL = 1e-5
TMIN = 1e-3
PIX_RTOL, PIX_ATOL, PIX_FRACTION = 2e-3, 2e-3, 0.995
R = 1024


def _soup_tris(n=300, seed=1, spread=10.0):
    """tests/test_bvh.py's `_random_tris`."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return base, v1, v2


def _soup_flat(builder, asarray):
    """A FlatScene-like namespace of the soup's BVH arrays and triangles in
    leaf order (tests/test_bvh.py's `_flat_with_bvh`), no bvh_nodes: the
    tracers pack the node rows themselves."""
    v0, v1, v2 = _soup_tris()
    bvh = builder(v0, v1, v2, max_leaf=4)
    o = bvh.tri_order
    t = len(o)
    positions = np.concatenate([v0[o], v1[o], v2[o]])
    indices = np.stack([np.arange(t), np.arange(t) + t,
                        np.arange(t) + 2 * t], -1).astype(np.int32)
    geom = types.SimpleNamespace(positions=asarray(positions),
                                 indices=asarray(indices), tri_geo=None)
    return types.SimpleNamespace(
        geometry=geom, bvh_bounds_lo=asarray(bvh.bounds_lo),
        bvh_bounds_hi=asarray(bvh.bounds_hi), bvh_skip=asarray(bvh.skip),
        bvh_tri_start=asarray(bvh.tri_start),
        bvh_tri_count=asarray(bvh.tri_count))


def _colonnade_flats():
    kw = dict(width=16, height=16, tracer="bvh")
    jf = jflatten(*jcolonnade(sphere_res=(12, 16)), JSettings(**kw))
    pf = flatten_scene(*make_colonnade_scene(sphere_res=(12, 16)),
                       RenderSettings(**kw), device="cpu")
    assert pf.bvh_nodes is not None and jf.bvh_nodes is not None
    np.testing.assert_array_equal(pf.bvh_nodes.numpy(),
                                  np.asarray(jf.bvh_nodes))
    return jf, pf


@pytest.fixture(scope="module")
def cases():
    """name -> (JAX flat, port flat, half-width of the ray origins'
    box)."""
    out = {}
    jf = _soup_flat(jbuild, jnp.asarray)
    pf = _soup_flat(build_bvh, torch.from_numpy)
    out["soup"] = (jf, pf, 12.0)
    jf, pf = _colonnade_flats()
    out["colonnade"] = (jf, pf, 8.0)
    return out


def _tri64(pflat):
    g = pflat.geometry
    p = g.positions.double().numpy()
    idx = g.indices.numpy()
    v0 = p[idx[:, 0]]
    return np.concatenate([v0, p[idx[:, 1]] - v0, p[idx[:, 2]] - v0], 1)


def _rays(seed, box, tris64):
    """Half the rays from free space in the box, aimed at points of random
    triangles (or their edges' extensions), half leaving triangle surfaces
    in random directions (the ties a bounce wave meets)."""
    rng = np.random.default_rng(seed)

    def points(n):
        t = tris64[rng.integers(0, len(tris64), n)]
        uv = rng.uniform(-0.1, 0.6, (n, 2))
        return t[:, 0:3] + uv[:, :1] * t[:, 3:6] + uv[:, 1:] * t[:, 6:9]

    h = R // 2
    o = rng.uniform(-box, box, (R, 3))
    d = rng.normal(size=(R, 3))
    d[:h] = points(h) - o[:h]
    o[h:] = points(R - h)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _t64(o, d, tri):
    """(t, smallest barycentric) of one ray against one float64 triangle."""
    v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    pv = np.cross(d, e2)
    det = e1 @ pv
    sv = o - v0
    qv = np.cross(sv, e1)
    u, v = (sv @ pv) / det, (d @ qv) / det
    return (e2 @ qv) / det, min(u, v, 1.0 - u - v)


def _hold(rec, jrec, o, d, tris64):
    hit, jhit = rec.hit.numpy(), np.asarray(jrec.hit)
    assert np.array_equal(hit, jhit)
    tri, jtri = rec.tri.numpy(), np.asarray(jrec.tri)
    t, jt = rec.t.numpy(), np.asarray(jrec.t)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=T_ATOL)
    apart = np.nonzero(tri != jtri)[0]
    for i in apart:
        (ta, ea), (tb, eb) = (_t64(o[i].astype(np.float64),
                                   d[i].astype(np.float64), tris64[k])
                              for k in (tri[i], jtri[i]))
        assert min(ea, eb) > -1e-6 and abs(ta - tb) <= TIE_RTOL * abs(tb), (
            f"ray {i}: triangles {tri[i]} / {jtri[i]} at t {ta} / {tb}")
    return len(apart)


@pytest.mark.parametrize("case", ["soup", "colonnade"])
@pytest.mark.parametrize("masked", [False, True])
def test_bvh_tracer_matches_jax(cases, case, masked):
    jf, pf, box = cases[case]
    tris64 = _tri64(pf)
    o, d = _rays(3 + masked, box, tris64)
    rng = np.random.default_rng(5)
    active = rng.random(R) < 0.7 if masked else None
    tmax = np.where(rng.random(R) < 0.5, np.inf,
                    rng.uniform(0.5, 6.0, R)).astype(np.float32)
    jc, ja = jtraverse.make_bvh_tracer(jf)
    pc, pa = traverse.make_bvh_tracer(pf)
    jact = None if active is None else jnp.asarray(active)
    act = None if active is None else torch.from_numpy(active)
    jrec = jax.jit(lambda o, d, tm, a: jc(o, d, TMIN, tm, a))(
        o, d, tmax, jact)
    rec = pc(torch.from_numpy(o), torch.from_numpy(d), TMIN,
             torch.from_numpy(tmax), act)
    _hold(rec, jrec, o, d, tris64)
    if active is not None:
        assert not rec.hit.numpy()[~active].any()
    live = np.ones(R, bool) if active is None else active
    assert rec.hit.numpy()[live].mean() > 0.15
    jocc = np.asarray(jax.jit(lambda o, d, tm, a: ja(o, d, TMIN, tm, a))(
        o, d, tmax, jact))
    occ = pa(torch.from_numpy(o), torch.from_numpy(d), TMIN,
             torch.from_numpy(tmax), act).numpy()
    assert np.array_equal(occ, jocc)
    # any hit never reports what closest hit does not see, and the reverse
    assert np.array_equal(occ, rec.hit.numpy())


def test_cornell_render_with_bvh_matches_jax():
    """tests/test_bvh.py's forced-BVH Cornell (24x24 x 4 spp, pcg4d) with
    tracer="bvh" in both packages, per pixel."""
    kw = dict(width=24, height=24, spp=4, max_bounces=4, sampler="pcg4d",
              tracer="bvh")
    jf = jflatten(*jcornell(), JSettings(**kw), accel_min_tris=1)
    ref = np.asarray(jintegrator.render(jf, JSettings(**kw)))
    pf = flatten_scene(*make_cornell_scene(), RenderSettings(**kw),
                       accel_min_tris=1, device="cpu")
    assert pf.bvh_skip is not None
    calls = []
    real = traverse.make_bvh_tracer

    def counted(flat, max_leaf=None):
        calls.append(max_leaf)
        return real(flat, max_leaf=max_leaf)

    traverse.make_bvh_tracer = counted
    try:
        img = integrator.render(pf, RenderSettings(**kw)).numpy()
    finally:
        traverse.make_bvh_tracer = real
    assert calls == [RenderSettings(**kw).accel_max_leaf]
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert close.mean() >= PIX_FRACTION, close.mean()
    assert abs(img.mean() / ref.mean() - 1.0) < 1e-3


def _picked(tracers):
    """Which module built a (trace_closest, trace_any) pair."""
    return tracers[0].__module__.rsplit(".", 1)[-1]


def test_auto_takes_the_bvh_tracer_without_wide_arrays():
    """tracer="auto" on a FlatScene whose wide arrays are None takes the
    bvh tracer in both packages (JAX integrator.py:107-110); with the wide
    arrays, the packet tracer."""
    kw = dict(width=8, height=8, tracer="auto")
    jf = jflatten(*jcornell(), JSettings(**kw), accel_min_tris=1)
    pf = flatten_scene(*make_cornell_scene(), RenderSettings(**kw),
                       accel_min_tris=1, device="cpu")
    wide = ("wbvh_nodes", "wbvh_tris", "wbvh_meta", "wbvh_slot", "wbvh_order")
    assert pf.wbvh_nodes is not None
    assert _picked(integrator.make_tracers(pf, RenderSettings(**kw))) \
        == "packet_trace"
    jbare = dataclasses.replace(jf, **{k: None for k in wide})
    pbare = dataclasses.replace(pf, **{k: None for k in wide})
    assert _picked(jintegrator.make_tracers(jbare, JSettings(**kw))) \
        == "traverse"
    assert _picked(integrator.make_tracers(pbare, RenderSettings(**kw))) \
        == "traverse"
    # without a binary BVH either, both fall through to brute force
    nobvh = dict.fromkeys(("bvh_skip", "bvh_nodes"))
    assert _picked(jintegrator.make_tracers(
        dataclasses.replace(jbare, **nobvh), JSettings(**kw))) == "intersect"
    assert _picked(integrator.make_tracers(
        dataclasses.replace(pbare, **nobvh), RenderSettings(**kw))) \
        == "intersect"


@pytest.mark.parametrize("option", [dict(oct_order=True),
                                    dict(mt_precision="high")])
def test_packet_options_are_refused_for_the_bvh_tracer(option):
    kw = dict(width=8, height=8, tracer="bvh")
    pf = flatten_scene(*make_cornell_scene(), RenderSettings(**kw),
                       accel_min_tris=1, device="cpu")
    with pytest.raises(ValueError, match="options of the packet kernel"):
        integrator.make_tracers(pf, RenderSettings(**kw, **option))
