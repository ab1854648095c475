"""The port's CPU render of the blessed goldens, part 1: the Cornell
configurations.

tests/golden_configs.py builds tests/test_golden.py's configurations with
the port (no JAX) and renders them as test_golden.py renders them (flatten
with accel_min_tris=32, integrator.render); each image is held to
tests/goldens/<name>.exr at test_golden.py's bar, RMSE <= 1e-3. Here:
cornell, cornell_pcg4d and cornell_dof, and cornell with tracer="bvh"
(accel_min_tris=1, so the scene has a binary BVH: the bvh tracer of
ops/traverse.py renders the golden). tests/test_torch_golden_lit.py holds
furnace_rough_metal and cutout_shadows. The three spheres configurations
(spheres, spheres_foreign_glb, spheres_gmon) trace instanced spheres with
the packet tracer, whose CPU version (the plain K3 brute force over every
block) takes ~15 min a golden here: chip_smoke.py 9b holds them on the
card only.
"""

import numpy as np
import pytest
import torch

import golden_configs as gc

torch.set_num_threads(1)


@pytest.mark.parametrize("name,tracer,min_tris", [
    ("cornell", None, 32), ("cornell_pcg4d", None, 32),
    ("cornell_dof", None, 32), ("cornell", "bvh", 1)])
def test_port_renders_the_golden(name, tracer, min_tris):
    img, _ = gc.render(name, "cpu", tracer=tracer,
                       accel_min_tris=min_tris)
    ref = gc.golden(name)
    assert img.shape == ref.shape
    assert np.isfinite(img).all() and img.mean() > 0
    err = gc.rmse(img, ref)
    assert err <= gc.RMSE_THRESHOLD, f"{name}: RMSE {err:.2e}"
