"""Progressive renderer API, torch edition.

Port of the library entry point of platinum_tpu/render/renderer.py
(README "Library API"): `Renderer(scene)`, `start_render` latches settings
and flattens the scene onto the device, `render()` advances one
progressive sample, `status` reports Ready/Busy/Done, `readback()` pulls
the image to the host and `export_exr` writes it through the shared
io/exr.py. GMoN buckets raise; the preview ladder, checkpoints, progress
and timing properties and `export_png` (post stack and tonemap) are not
ported yet.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.types import FLAG_GMON, FlatScene, RenderSettings


class RenderStatus(enum.IntFlag):
    READY = 1
    BUSY = 2
    DONE = 4


class Renderer:
    def __init__(self, scene, device=None):
        """`device`: where the scene and the accumulator live (default:
        the current CUDA device when there is one, else the CPU)."""
        self.scene = scene
        self.device = torch.device(
            device if device is not None
            else ("cuda" if torch.cuda.is_available() else "cpu"))
        self.settings: RenderSettings | None = None
        self.flat: FlatScene | None = None
        self._accum = None
        self._accumulated = 0

    def start_render(self, camera_node_id: int | None = None,
                     settings: RenderSettings | None = None):
        """Latch settings, flatten the scene and reset accumulation."""
        self.settings = settings or self.settings or RenderSettings()
        if self.settings.flags & FLAG_GMON and self.settings.gmon_buckets > 1:
            raise NotImplementedError("GMoN accumulation is not ported yet")
        self.flat = flatten_scene(self.scene, camera_node_id, self.settings,
                                  device=self.device)
        self._features = analyze_features(self.flat)
        self._accum = torch.zeros((self.settings.num_pixels, 3),
                                  device=self.device)
        self._accumulated = 0

    def render(self):
        """One progressive step: one sample per pixel."""
        if self.flat is None or self.status & RenderStatus.DONE:
            return
        self._accum = integrator.render_step(
            self.flat, self.settings, self._accum, self._accumulated,
            sample_seed=self._accumulated, features=self._features)
        self._accumulated += 1

    @property
    def status(self) -> RenderStatus:
        if self.flat is None:
            return RenderStatus.READY
        if self._accumulated < self.settings.spp:
            return RenderStatus.READY | RenderStatus.BUSY
        return RenderStatus.READY | RenderStatus.DONE

    def readback(self) -> np.ndarray:
        """(H, W, 3) linear radiance in the working colorspace."""
        s = self.settings
        return self._accum.cpu().numpy().reshape(s.height, s.width, 3)

    def export_exr(self, path: str):
        from platinum_tpu.io.exr import write_exr

        write_exr(path, self.readback())
