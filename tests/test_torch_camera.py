"""platinum_tpu_torch camera rays vs the JAX package's, with the thin lens
open: polygonal aperture blended toward a circle, bokeh power remap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.app.scenes import make_cornell_scene
from platinum_tpu.models.camera_rays import spawn_camera_rays as jspawn
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.convert import flat_from_numpy
from platinum_tpu_torch.models.camera_rays import spawn_camera_rays

torch.set_num_threads(1)


@pytest.mark.parametrize("blades,roundness,bokeh", [(7, 1.0, 0.0),
                                                    (5, 0.25, 1.0),
                                                    (6, 0.0, -0.5)])
def test_dof_camera_rays_match_jax(blades, roundness, bokeh):
    scene, cam = make_cornell_scene(aperture=2.8)
    c = scene.node(cam).camera
    c.aperture_blades, c.roundness, c.bokeh_power = blades, roundness, bokeh
    jflat = jflatten(scene, cam, JSettings(width=40, height=30))
    assert float(jflat.camera.aperture_radius) > 0.0
    flat = flat_from_numpy(jax.tree.map(np.asarray, jflat), "cpu")

    rng = np.random.default_rng(blades)
    n = 40 * 30
    px, py = np.arange(n) % 40, np.arange(n) // 40
    jit = rng.random((n, 2), dtype=np.float32)
    lens = rng.random((n, 2), dtype=np.float32)
    jo, jd = jspawn(jflat.camera, jnp.asarray(px, jnp.uint32),
                    jnp.asarray(py, jnp.uint32), jnp.asarray(jit),
                    jnp.asarray(lens))
    o, d = spawn_camera_rays(flat.camera, torch.from_numpy(px),
                             torch.from_numpy(py), torch.from_numpy(jit),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    # the lens actually moved the origins
    assert np.ptp(o.numpy(), axis=0).max() > 1e-3
