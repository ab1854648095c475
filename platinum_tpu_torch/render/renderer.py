"""Progressive renderer API, torch edition.

Port of the library entry point of platinum_tpu/render/renderer.py
(README "Library API"): `Renderer(scene)`, `start_render` latches settings,
flattens the scene onto the device, builds the (trace_closest, trace_any)
pair once (for the auto plan's probe and every sample) and resolves
compact_plan="auto", `render()` advances one progressive sample, `status`
reports
Ready/Busy/Done, `readback()` pulls the image to the host, `export_exr`
writes it through io/exr.py, and `update_instance_transform` refits an
instanced scene after a transform edit. GMoN buckets raise; the preview
ladder, checkpoints, progress and timing properties, `export_png` and the
post stack (`post_options`) and the partitioned branch of the transform
edit are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from platinum_tpu_torch.accel.tlas import update_instance_transform
from platinum_tpu_torch.render import autoplan, integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.types import (FLAG_GMON, FlatScene,
                                             RenderSettings, resolve_device)


class RenderStatus(enum.IntFlag):
    READY = 1
    BUSY = 2
    DONE = 4


class Renderer:
    def __init__(self, scene, post_options=None, *, device="cuda"):
        """`post_options` (the JAX Renderer's post stack) is not ported
        yet: any value but None raises NotImplementedError. `device`:
        where the scene and the accumulator live (default: the current
        CUDA device; raises when there is none, and runs on the CPU only
        when asked with device="cpu")."""
        if post_options is not None:
            raise NotImplementedError(
                "Renderer(post_options=...): the post stack is not ported "
                "to platinum_tpu_torch yet (ROADMAP queue 1)")
        self.scene = scene
        self.device = resolve_device(device)
        self.settings: RenderSettings | None = None
        self.flat: FlatScene | None = None
        self._tracers = None
        self._accum = None
        self._accumulated = 0

    def start_render(self, camera_node_id: int | None = None,
                     settings: RenderSettings | None = None):
        """Latch settings, flatten the scene and reset accumulation."""
        self.settings = settings or self.settings or RenderSettings()
        if self.settings.flags & FLAG_GMON and self.settings.gmon_buckets > 1:
            raise NotImplementedError("GMoN accumulation is not ported yet")
        batch = max(1, self.settings.spp_batch)
        if self.settings.spp % batch != 0:
            # the JAX Renderer finds this out at its last batch
            raise ValueError(f"settings.spp ({self.settings.spp}) must be a "
                             f"multiple of spp_batch ({batch})")
        self._host_accel = {}
        self.flat = flatten_scene(self.scene, camera_node_id, self.settings,
                                  device=self.device,
                                  host_accel_out=self._host_accel)
        self._features = analyze_features(self.flat)
        if self.settings.tracer == "bf" and self.flat.wbvh_meta is not None:
            # the tree's depth once, here, as the JAX Renderer does
            # (renderer.py:78-85); make_tracers hands it to the tracer
            from platinum_tpu_torch.ops.bfstream import _tree_depth

            self.settings = dataclasses.replace(
                self.settings,
                bf_depth=_tree_depth(self.flat.wbvh_meta.cpu().numpy()))
        self._tracers = integrator.make_tracers(self.flat, self.settings)
        if self.settings.compact_plan == "auto":
            self.settings = autoplan.resolve_auto_plan(
                self.flat, self.settings, tracers=self._tracers)
        self._accum = torch.zeros((self.settings.num_pixels, 3),
                                  device=self.device)
        self._accumulated = 0

    def render(self):
        """One progressive step: one sample per pixel, or spp_batch
        samples per pixel in one sample-batched wavefront."""
        if self.flat is None or self.status & RenderStatus.DONE:
            return
        batch = max(1, self.settings.spp_batch)
        self._accum = integrator.render_step_n(
            self.flat, self.settings, self._accum, self._accumulated,
            batch, features=self._features, tracers=self._tracers)
        self._accumulated += batch

    def update_instance_transform(self, node_id: int, transform=None):
        """Apply a transform edit without rebuilding the BVH (instanced
        scenes; the JAX Renderer's single-structure branch): the
        instance's world-space BLAS rows and feature matrix are recomputed,
        the TLAS is refit in place, the changed tables are uploaded, the
        tracer pair is built again over them and accumulation restarts.
        Raises for a scene that is not instanced."""
        if not self._host_accel or self.flat.instances is None:
            raise ValueError("scene is not instanced; call start_render()")
        if transform is not None:
            self.scene.node(node_id).transform = transform
        idx = next((i for i, inst in enumerate(self._host_accel["instances"])
                    if inst.node_id == node_id), None)
        if idx is None:
            raise KeyError(f"node {node_id} is not a mesh instance")
        ibvh = self._host_accel["ibvh"]
        m = self.scene.world_transform(node_id)
        update_instance_transform(ibvh, self._host_accel["mesh_wides"], idx, m)
        a = np.asarray(m[:3, :3], np.float64)
        rows = self.flat.instances.rows.clone()
        rows[idx, 0:9] = torch.from_numpy(a.reshape(-1).astype(np.float32))
        rows[idx, 9:18] = torch.from_numpy(
            np.linalg.inv(a).T.reshape(-1).astype(np.float32))
        feat = self.flat.instances.feat.clone()
        feat[idx] = torch.from_numpy(ibvh.inst_feat[idx]).to(self.device)
        self.flat = dataclasses.replace(
            self.flat,
            wbvh_nodes=torch.from_numpy(ibvh.nodes).to(self.device),
            instances=dataclasses.replace(self.flat.instances, rows=rows,
                                          feat=feat))
        self._tracers = integrator.make_tracers(self.flat, self.settings)
        self._accum = torch.zeros_like(self._accum)
        self._accumulated = 0

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
        from platinum_tpu_torch.io.exr import write_exr

        write_exr(path, self.readback())
