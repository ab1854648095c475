"""Alpha cutout on the small colonnade, the port against the JAX package.

The small colonnade of tests/test_torch_slice.py with the golden's checker
texture (alpha and all) on its `column` material (tests/alpha_scenes.py),
through the packet tracer: 32x32 at 2 spp and 8 bounces, and with
compact=True and spp_batch=8 (8,192 lanes: the static plan compacts) at 8
spp and 4 bounces. Held to JAX's render_step_n by the slice's bars, with
no any-hit wave traced (tests/test_torch_alpha.py). Cut-out columns show
the floor through them where each column's base cap is coplanar with it:
the two packages break those exact-t ties alike only because the port
forms hit points with JAX's fused multiply-add (ops/hitdata.py).
"""

import pytest
import torch

from alpha_scenes import checker_columns
from test_torch_alpha import hold, render_both

torch.set_num_threads(1)

COLONNADE = dict(width=32, height=32, kernel="mis", sampler="halton",
                 tracer="packet", instancing="off")
CONFIGS = {
    "plain": dict(COLONNADE, spp=2, max_bounces=8),
    "compact": dict(COLONNADE, spp=8, spp_batch=8, compact=True,
                    max_bounces=4),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_checker_columns_render_matches_jax(name):
    kw = CONFIGS[name]
    scene, cam = checker_columns("platinum_tpu")
    img, ref, flat = render_both(scene, cam, kw, 32)
    hold(img, ref, f"checker columns {name}")
    assert flat.wbvh_nodes is not None and flat.atlas is not None
    # the camera sees the lit hall
    assert ref.mean() > 0.5
