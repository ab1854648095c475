"""The port's host-driven bounce loop (`render_sample_stepped`, one
`bounce_step` a bounce) against the JAX package's `render_sample_stepped`
(one `bounce_step_jit` program a bounce), on the CPU.

Both packages render the same FlatScene (the JAX flatten, carried across
with flat_from_numpy) at the same sample index. Bars: per pixel
rtol=2e-3 / atol=2e-3 on >= 99.5% of pixels, the image means to 1e-3
relative (tests/test_torch_slice.py's), and the rays traced equal.
`fuse_shadow=True` is turned off by both, and the stepped loop equals
render_sample's bounce loop without compaction.
"""

import jax
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_cornell_scene
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL, PIX_FRACTION = 2e-3, 2e-3, 0.995
MEAN_RTOL = 1e-3


@pytest.mark.parametrize("kw", [
    dict(tracer="brute", sampler="halton", fuse_shadow=True),
    dict(tracer="bvh", sampler="pcg4d"),
], ids=["brute_fuse_shadow", "bvh"])
def test_render_sample_stepped_matches_jax(kw):
    kw = dict(width=16, height=16, max_bounces=6, kernel="mis", **kw)
    jflat = jflatten(*make_cornell_scene(), JSettings(**kw), accel_min_tris=1)
    ref, jrays = jintegrator.render_sample_stepped(
        jflat, JSettings(**kw), 3, features=janalyze(jflat),
        return_stats=True)
    ref = np.asarray(ref)
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    feats = analyze_features(flat)
    img, rays = integrator.render_sample_stepped(
        flat, RenderSettings(**kw), 3, features=feats, return_stats=True)
    img = img.numpy()
    assert img.shape == ref.shape == (256, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    assert close.mean() >= PIX_FRACTION, close.mean()
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_RTOL
    assert float(rays) == float(jrays)
    # the same bounces as render_sample's loop without fuse_shadow
    plain = dict(kw, fuse_shadow=False)
    again = integrator.render_sample(flat, RenderSettings(**plain), 3,
                                     features=feats)
    assert torch.equal(again, torch.from_numpy(img))


def test_bounce_step_is_one_bounce():
    """bounce_step advances the state by one bounce, as make_bounce_body's
    body does (JAX's bounce_step_jit)."""
    kw = dict(width=8, height=8, max_bounces=4, kernel="mis")
    jflat = jflatten(*make_cornell_scene(), JSettings(**kw))
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")
    settings = RenderSettings(**kw)
    feats = analyze_features(flat)
    state = integrator.init_path_state(flat, settings, 0)
    one = integrator.bounce_step(flat, settings, state, feats)
    body = integrator.make_bounce_body(flat, settings, feats)
    two = body(integrator.init_path_state(flat, settings, 0))
    assert one["bounce"] == two["bounce"] == 1
    for k in ("L", "atten", "active", "o", "d"):
        assert torch.equal(one[k], two[k]), k
