"""Wavefront compaction in platinum_tpu_torch vs the JAX package: the
compaction plan (static, explicit and sharded), the lanes `_compact_state`
keeps and their weights (bitwise, on a state whose random keys tie),
autoplan's plan building and validation, the measured plan on Cornell,
and compacted Cornell renders at 128x64 (8,192 lanes, the smallest wave
the plans compact) under the slice's bars: per pixel rtol=2e-3,
atol=2e-3 on >= 99.5% of pixels, means within 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_cornell_scene
from platinum_tpu.render import autoplan as jautoplan
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.ops import threefry
from platinum_tpu_torch.render import autoplan, integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3
CORNELL = dict(width=128, height=64, spp=1, max_bounces=8, kernel="mis",
               sampler="halton", tracer="brute", compact=True)


@pytest.mark.parametrize("n,kw", [
    (8192, dict(width=128, height=64, max_bounces=8)),
    (262_144, dict(width=512, height=512, max_bounces=8)),
    (262_144, dict(width=512, height=512, max_bounces=50)),
    (8191, dict(width=8191, height=1, max_bounces=8)),       # too few lanes
    (65_536, dict(width=256, height=256, max_bounces=3)),    # too few bounces
    (262_144, dict(width=512, height=512, max_bounces=8,
                   compact_plan=((262_144, 2), (65_536, 5), (8192, 8)))),
    # a shard of a quarter of the wave: caps rescale to its share
    (65_536, dict(width=512, height=512, max_bounces=8,
                  compact_plan=((262_144, 2), (65_536, 5), (8192, 8)))),
    (65_536, dict(width=512, height=512, max_bounces=8,
                  compact_plan=((262_144, 2), (262_144, 4), (4096, 8)))),
])
def test_compaction_plan_matches_jax(n, kw):
    kw = dict(kw, compact=True)
    assert integrator._compaction_plan(n, RenderSettings(**kw)) == \
        jintegrator._compaction_plan(n, JSettings(**kw))
    off = dict(kw, compact=False, compact_plan=None)
    assert integrator._compaction_plan(n, RenderSettings(**off)) == \
        jintegrator._compaction_plan(n, JSettings(**off))


def _state(n, live_fraction, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        o=rng.normal(size=(n, 3)).astype(np.float32),
        atten=rng.random((n, 3), np.float32),
        L=rng.random((n, 3), np.float32),
        active=rng.random(n) < live_fraction,
        slot=np.arange(n, dtype=np.int32),
        prev_pdf=rng.random(n, np.float32),
    )


@pytest.mark.parametrize("cap", [131_072, 200_192])
def test_compact_state_selects_the_same_lanes(cap):
    """262,144 lanes: u's 2^-23 grid puts thousands of equal keys in one
    draw, so only a stable sort picks JAX's lanes."""
    n = 262_144
    st = _state(n, 0.6)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 5), 1)
    u = np.asarray(jax.random.uniform(jkey, (n,)))
    assert n - np.unique(u).size > 1000           # ties in the keys
    ref = jintegrator._compact_state(
        {k: jnp.asarray(v) for k, v in st.items()} | {"bounce": jnp.int32(2)},
        cap, jkey)
    got = integrator._compact_state(
        {k: torch.from_numpy(v) for k, v in st.items()} | {"bounce": 2},
        cap, threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), 5), 1))
    np.testing.assert_array_equal(got["slot"].numpy(), np.asarray(ref["slot"]))
    np.testing.assert_array_equal(got["atten"].numpy(),
                                  np.asarray(ref["atten"]))
    for k in ("o", "active", "prev_pdf"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["L"].shape == (cap, 3) and not got["L"].any()
    assert got["bounce"] == 2


def test_plan_from_live_and_validate_plan_match_jax():
    rng = np.random.default_rng(11)
    for max_bounces in (4, 8, 16):
        for _ in range(5):
            live = np.sort(rng.random(max_bounces))[::-1] * rng.random()
            for n in (8192, 262_144):
                assert autoplan.plan_from_live(live, n, max_bounces) == \
                    jautoplan.plan_from_live(live, n, max_bounces)
    good = ((8192, 2), (4096, 5), (1024, 8))
    autoplan.validate_plan(good, 8192, 8)
    for bad in ((), ((8192, 2), (9000, 8)), ((8192, 3), (4096, 3), (512, 8)),
                ((8192, 2), (4096, 6)), ((0, 8),), ((8192,),)):
        with pytest.raises(ValueError):
            jautoplan.validate_plan(bad, 8192, 8)
        with pytest.raises(ValueError):
            autoplan.validate_plan(bad, 8192, 8)


@pytest.fixture(scope="module")
def cornell():
    scene, cam = make_cornell_scene()
    jflat = jflatten(scene, cam, JSettings(**CORNELL))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    return jflat, flat


def test_resolve_auto_plan_matches_jax_on_cornell(cornell):
    jflat, flat = cornell
    kw = dict(CORNELL, compact_plan="auto")
    ref = jautoplan.resolve_auto_plan(jflat, JSettings(**kw))
    got = autoplan.resolve_auto_plan(flat, RenderSettings(**kw))
    assert isinstance(got.compact_plan, tuple) and len(got.compact_plan) > 1
    assert got.compact_plan == ref.compact_plan
    small = dict(kw, width=64)                        # 4,096 lanes
    assert autoplan.resolve_auto_plan(
        flat, RenderSettings(**small)).compact_plan is None
    np.testing.assert_allclose(
        autoplan.measure_live_fractions(flat, RenderSettings(**kw)),
        jautoplan.measure_live_fractions(jflat, JSettings(**kw)), atol=1e-3)


@pytest.mark.parametrize("plan", [None, "auto"])
def test_compacted_cornell_render_matches_jax(cornell, plan):
    jflat, flat = cornell
    kw = dict(CORNELL, compact_plan=plan)
    jset = jautoplan.resolve_auto_plan(jflat, JSettings(**kw))
    n = jset.num_pixels
    assert len(jintegrator._compaction_plan(n, jset)) > 1
    ref = np.asarray(jintegrator.render_step_n(
        jflat, jset, jnp.zeros((n, 3)), jnp.int32(0), 1,
        features=janalyze(jflat)))
    # integrator.render resolves "auto" itself, as the JAX package's does
    img = integrator.render(flat, RenderSettings(**kw),
                            features=analyze_features(flat)).numpy()
    img = img.reshape(-1, 3)
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert np.isfinite(img).all()
    assert close.mean() >= PIX_FRACTION
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_RTOL


def test_compaction_is_unbiased_against_the_dense_render(cornell):
    """The compacted estimator's mean equals the dense one's in
    expectation (the Horvitz-Thompson weight), here within 3%."""
    _, flat = cornell
    kw = dict(CORNELL, spp=2)
    feats = analyze_features(flat)
    dense = integrator.render(flat, RenderSettings(**dict(kw, compact=False)),
                              features=feats).numpy()
    comp = integrator.render(flat, RenderSettings(**kw),
                             features=feats).numpy()
    assert abs(comp.mean() / dense.mean() - 1.0) < 0.03
