"""A transform edit in the middle of the preview ladder, the port's
Renderer against the JAX Renderer.

The 24-instance scene of tests/test_tlas.py (tests/instanced_scenes.py,
built by each package's own scene graph) flattened with instancing="on"
renders at 24x24 with preview_scale=2 and preview_spp=3. After the first
preview frame, update_instance_transform moves an instance in front of
the camera. The JAX preview keeps its own flatten and tracers, so its
remaining frames show the scene as it was; the port's preview keeps its
own scene and tracer pair too, so each of its frames must equal JAX's to
the bars of tests/test_torch_slice.py (per pixel rtol = atol = 2e-3 on >=
99.5% of pixels, the means to 1e-3 relative). The full-resolution steps
after the ladder render the edited scene in both, held the same way. A
preview that traced the refit tree with the old instance rows would put
the moved instance's hit points off its surface and fail the bars.
"""

import numpy as np
import torch

from instanced_scenes import instanced_scene
from platinum_tpu.core.transform import Transform as JTransform
from platinum_tpu.render.renderer import Renderer as JRenderer
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.render.renderer import Renderer
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3
PIX_FRACTION = 0.995
MEAN_RTOL = 1e-3
KW = dict(width=24, height=24, spp=2, max_bounces=3, kernel="mis",
          sampler="halton", tracer="packet", instancing="on")
MOVED = "i0"
MOVE = dict(translation=[0.0, 0.5, 6.0], rotation=[0.3, 0.2, 0.1],
            scale=[1.5] * 3)


def _drive(pkg, R, S, T):
    scene, cam = instanced_scene(pkg)
    node = next(n for n in scene._nodes if scene.node(n).name == MOVED)
    r = R(scene) if R is JRenderer else R(scene, device="cpu")
    r.start_render(cam, S(**KW), preview_scale=2, preview_spp=3)
    frames = []
    r.render()
    frames.append(np.asarray(r.readback()))
    r.update_instance_transform(node, T(**MOVE))
    while not r.status & 4:             # RenderStatus.DONE
        r.render()
        frames.append(np.asarray(r.readback()))
    return r, frames


def test_preview_frames_after_a_transform_edit_match_jax():
    jr, jframes = _drive("platinum_tpu", JRenderer, JSettings, JTransform)
    r, frames = _drive("platinum_tpu_torch", Renderer, RenderSettings,
                       Transform)
    # three preview frames, then the two full-resolution steps
    assert len(frames) == len(jframes) == 5
    assert r._pv["done"] == jr._pv["done"] == 3
    for k, (img, ref) in enumerate(zip(frames, jframes)):
        close = np.isclose(img, ref, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
        rel = abs(img.mean() / ref.mean() - 1.0)
        print(f"frame {k}: {int((~close).sum())} pixels outside, mean "
              f"{img.mean():.6f} vs {ref.mean():.6f} (rel {rel:.2e})")
        assert img.shape == ref.shape == (24, 24, 3)
        assert np.isfinite(img).all()
        assert close.mean() >= PIX_FRACTION
        assert rel <= MEAN_RTOL
    # the edit shows: the full-resolution image is not the stale preview's
    assert np.abs(frames[-1] - frames[2]).max() > 0.1
