"""Progressive renderer API, torch edition.

Port of platinum_tpu/render/renderer.py (parity with
renderer_pt::Renderer): `Renderer(scene, post_options)`; `start_render`
latches settings, flattens the scene onto the device, builds the
(trace_closest, trace_any) pair once (for the auto plan's probe and every
sample) and resolves compact_plan="auto"; `render()` advances one
progressive sample (or `spp_batch` samples) into the GMoN bucket it belongs
to; `status`, `completed_spp`, `render_progress` and `render_time` report
progress; `readback()` pulls the image to the host (the GMoN combine of the
buckets, or during the preview ladder the low-resolution frame upscaled);
`output_image` runs the post stack, `export_png` / `export_exr` write the
result, `save_checkpoint` / `load_checkpoint` keep the accumulators in the
JAX package's `.npz` keys, and `update_instance_transform` refits an
instanced scene after a transform edit. With PLATINUM_TPU_LOG set it emits
the JAX Renderer's telemetry events (utils/telemetry.py).

One difference from the JAX Renderer: the preview ladder renders from the
full-resolution flatten with the camera constants of the preview size
(JAX flattens the scene a second time at that size; the arrays are the
same but the camera's). The preview keeps that scene and its own tracer
pair, the one start_render built over the same arrays, in `_pv`: a
transform edit during the ladder replaces `self.flat` and the main pair
but not the preview's, which stays stale but consistent, as the JAX
preview does. Over a partitioned instanced scene the transform edit
refits the owning partition alone (JAX renderer.py:237-260).
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np
import torch

from platinum_tpu_torch.accel.tlas import update_instance_transform
from platinum_tpu_torch.ops.gmon import gmon_combine
from platinum_tpu_torch.post.options import PostProcessOptions
from platinum_tpu_torch.post.pipeline import postprocess_jit
from platinum_tpu_torch.render import autoplan, integrator
from platinum_tpu_torch.render.flatten import (_camera_constants,
                                               _instanced_part_arrays,
                                               analyze_features, flatten_scene)
from platinum_tpu_torch.render.types import (FLAG_GMON, FlatScene,
                                             RenderSettings, resolve_device)
from platinum_tpu_torch.utils import telemetry


class RenderStatus(enum.IntFlag):
    READY = 1
    BUSY = 2
    DONE = 4


class Renderer:
    def __init__(self, scene, post_options: PostProcessOptions | None = None,
                 *, device="cuda"):
        """`post_options`: the post stack of `output_image` / `export_png`
        (default PostProcessOptions()). `device`: where the scene and the
        accumulators live (default: the current CUDA device; raises when
        there is none, and runs on the CPU only when asked with
        device="cpu")."""
        self.scene = scene
        self.post_options = post_options or PostProcessOptions()
        self.device = resolve_device(device)
        self.settings: RenderSettings | None = None
        self.flat: FlatScene | None = None
        self._tracers = None
        self._buckets = None        # list of B (H*W, 3) accumulators
        self._accumulated = 0
        self._pv = None
        self._start_time = None
        self._end_time = None
        self._last_log = 0.0

    # ------------------------------------------------------------------
    # Control
    # ------------------------------------------------------------------

    def start_render(self, camera_node_id: int | None = None,
                     settings: RenderSettings | None = None,
                     preview_scale: int = 0, preview_spp: int = 8):
        """Latch settings, flatten the scene and reset accumulation.

        `preview_scale` > 1 turns on the preview ladder: the first
        `preview_spp` steps render at (W/scale, H/scale), and `readback()`
        upscales them until the full-resolution accumulator has caught up
        (a handful of samples). Full-resolution accumulation starts from
        sample 0 after the preview, so the final image is the same with
        the ladder on or off."""
        self.settings = settings or self.settings or RenderSettings()
        n_buckets = max(1, self.settings.gmon_buckets
                        if self.settings.flags & FLAG_GMON else 1)
        batch = max(1, self.settings.spp_batch)
        if batch > 1 and n_buckets > 1:
            raise ValueError("spp_batch > 1 is incompatible with GMoN "
                             "bucketing; use spp_batch=1")
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
        # one device accumulator per bucket: a step updates one of them
        self._buckets = [torch.zeros((self.settings.num_pixels, 3),
                                     device=self.device)
                         for _ in range(n_buckets)]
        self._accumulated = 0

        self._pv = None
        if preview_scale and preview_scale > 1:
            s = self.settings
            pv_settings = dataclasses.replace(
                s, width=-(-s.width // preview_scale),
                height=-(-s.height // preview_scale),
                spp=preview_spp,
                # preview steps are single-spp render_step calls
                spp_batch=1,
                flags=s.flags & ~FLAG_GMON)
            if camera_node_id is None:
                camera_node_id = self.scene.get_cameras()[0][0]
            # the plan resolved above carries over: _compaction_plan scales
            # its caps to the preview's wave, as in the JAX Renderer
            pv_flat = dataclasses.replace(self.flat, camera=_camera_constants(
                self.scene, camera_node_id, pv_settings, self.device))
            self._pv = dict(
                flat=pv_flat, settings=pv_settings, scale=preview_scale,
                # pv_flat's arrays are self.flat's: the pair traces them
                tracers=self._tracers,
                accum=torch.zeros((pv_settings.num_pixels, 3),
                                  device=self.device),
                done=0, spp=preview_spp)
        self._start_time = time.perf_counter()
        self._end_time = None

    def render(self):
        """One progressive step: one sample per pixel into its GMoN bucket,
        or spp_batch samples per pixel in one sample-batched wavefront.
        During the preview ladder a step advances the low-resolution
        accumulator instead; full-resolution sample indices are untouched."""
        if self.flat is None or self.status & RenderStatus.DONE:
            return
        if self._pv is not None and self._pv["done"] < self._pv["spp"]:
            pv = self._pv
            t0 = time.perf_counter()
            pv["accum"] = integrator.render_step(
                pv["flat"], pv["settings"], pv["accum"], pv["done"],
                sample_seed=pv["done"], features=self._features,
                tracers=pv["tracers"])
            pv["done"] += 1
            if telemetry.enabled():
                if pv["accum"].is_cuda:
                    torch.cuda.synchronize(pv["accum"].device)
                telemetry.log_event("preview_frame", frame=pv["done"],
                                    scale=pv["scale"],
                                    ms=(time.perf_counter() - t0) * 1e3)
            return
        s = self.settings
        n_buckets = len(self._buckets)
        batch = max(1, s.spp_batch)
        if batch > 1:
            self._buckets[0] = integrator.render_step_n(
                self.flat, s, self._buckets[0], self._accumulated, batch,
                features=self._features, tracers=self._tracers)
            self._accumulated += batch
        else:
            samples_per_bucket = -(-s.spp // n_buckets)
            bucket = min(self._accumulated // samples_per_bucket,
                         n_buckets - 1)
            local_idx = self._accumulated % samples_per_bucket
            self._buckets[bucket] = integrator.render_step(
                self.flat, s, self._buckets[bucket], local_idx,
                sample_seed=self._accumulated, features=self._features,
                tracers=self._tracers)
            self._accumulated += 1
        if telemetry.enabled():
            now = time.perf_counter()
            if self._accumulated == s.spp or now - self._last_log > 2.0:
                self._last_log = now
                el = max(now - self._start_time, 1e-9)
                sps = self._accumulated / el
                telemetry.log_event(
                    "render_step", spp_done=self._accumulated, spp=s.spp,
                    elapsed_s=el, spp_per_sec=sps,
                    paths_per_sec=sps * s.num_pixels,
                    progress=self._accumulated / s.spp)
        if self._accumulated >= s.spp:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._end_time = time.perf_counter()
            telemetry.log_event("render_done", spp=s.spp,
                                elapsed_s=self._end_time - self._start_time)

    def render_all(self):
        while not (self.status & RenderStatus.DONE):
            self.render()

    def update_instance_transform(self, node_id: int, transform=None):
        """Apply a transform edit without rebuilding the BVH (instanced
        scenes): the instance's world-space BLAS rows and feature matrix
        are recomputed, the TLAS is refit in place, the changed tables are
        uploaded, the tracer pair is built again over them and
        accumulation restarts. Over partitions (accel/tlas.py
        partition_instanced) only the owning partition is refit, against
        its compacted mesh library, and its 7-tuple formed again. Raises
        for a scene that is not instanced."""
        if not self._host_accel or self.flat.instances is None:
            raise ValueError("scene is not instanced; call start_render()")
        if transform is not None:
            self.scene.node(node_id).transform = transform
        idx = next((i for i, inst in enumerate(self._host_accel["instances"])
                    if inst.node_id == node_id), None)
        if idx is None:
            raise KeyError(f"node {node_id} is not a mesh instance")
        ibvh = self._host_accel["ibvh"]
        wides = self._host_accel["mesh_wides"]
        m = self.scene.world_transform(node_id)
        if ibvh is not None:
            update_instance_transform(ibvh, wides, idx, m)
            feat_row = ibvh.inst_feat[idx]
            accel = dict(wbvh_nodes=torch.from_numpy(ibvh.nodes).to(
                self.device))
        else:
            parts = list(self.flat.wbvh_parts)
            for pi, (part, gids, used) in enumerate(
                    self._host_accel["ibvh_parts"]):
                where = np.nonzero(np.asarray(gids) == idx)[0]
                if not len(where):
                    continue
                local = int(where[0])
                update_instance_transform(part, [wides[u] for u in used],
                                          local, m)
                feat_row = part.inst_feat[local]
                parts[pi] = _instanced_part_arrays(part, gids, self.device)
                break
            else:
                raise KeyError(f"instance {idx} not in any partition")
            accel = dict(wbvh_parts=tuple(parts))
        a = np.asarray(m[:3, :3], np.float64)
        rows = self.flat.instances.rows.clone()
        rows[idx, 0:9] = torch.from_numpy(a.reshape(-1).astype(np.float32))
        rows[idx, 9:18] = torch.from_numpy(
            np.linalg.inv(a).T.reshape(-1).astype(np.float32))
        feat = self.flat.instances.feat.clone()
        feat[idx] = torch.from_numpy(feat_row).to(self.device)
        self.flat = dataclasses.replace(
            self.flat, **accel,
            instances=dataclasses.replace(self.flat.instances, rows=rows,
                                          feat=feat))
        self._tracers = integrator.make_tracers(self.flat, self.settings)
        self._buckets = [torch.zeros_like(b) for b in self._buckets]
        self._accumulated = 0
        self._start_time = time.perf_counter()
        self._end_time = None

    @property
    def status(self) -> RenderStatus:
        if self.flat is None:
            return RenderStatus.READY
        if self._accumulated < self.settings.spp:
            return RenderStatus.READY | RenderStatus.BUSY
        return RenderStatus.READY | RenderStatus.DONE

    @property
    def completed_spp(self) -> int:
        return self._accumulated

    @property
    def render_progress(self) -> float:
        if self.flat is None or self.settings.spp == 0:
            return 0.0
        return self._accumulated / self.settings.spp

    @property
    def render_time(self) -> float:
        if self._start_time is None:
            return 0.0
        end = self._end_time or time.perf_counter()
        return end - self._start_time

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    def _combined(self) -> torch.Tensor:
        n_buckets = len(self._buckets)
        if n_buckets == 1:
            return self._buckets[0]
        samples_per_bucket = -(-self.settings.spp // n_buckets)
        full = max(1, min(
            (self._accumulated + samples_per_bucket - 1) // samples_per_bucket,
            n_buckets))
        cap = self.settings.gmon_cap or 1.0
        return gmon_combine(torch.stack(self._buckets), full, cap)

    def _preview_active(self) -> bool:
        """Show the upscaled preview until the full-resolution accumulator
        has comparable per-pixel noise (a handful of samples), and never
        past the end of the render."""
        return (self._pv is not None and self._pv["done"] > 0
                and self._accumulated < min(self._pv["done"], 4,
                                            self.settings.spp))

    def readback(self) -> np.ndarray:
        """(H, W, 3) linear radiance in the working colorspace. During the
        preview ladder this is the low-resolution frame upscaled
        (nearest-neighbour) to the full output size."""
        s = self.settings
        if self._preview_active():
            pv = self._pv
            ps = pv["settings"]
            img = pv["accum"].cpu().numpy().reshape(ps.height, ps.width, 3)
            k = pv["scale"]
            img = np.repeat(np.repeat(img, k, axis=0), k, axis=1)
            return img[:s.height, :s.width]
        return self._combined().cpu().numpy().reshape(s.height, s.width, 3)

    def output_image(self, post_options: PostProcessOptions | None = None
                     ) -> np.ndarray:
        """Display-encoded (H, W, 3) float in the output colorspace; the
        post stack runs on the accumulator's device."""
        s = self.settings
        img = self._combined().reshape(s.height, s.width, 3)
        out = postprocess_jit(img, post_options or self.post_options,
                              s.working_space, s.output_space)
        return out.cpu().numpy()

    def export_png(self, path: str, post_options=None):
        from platinum_tpu_torch.io.png import write_png

        write_png(path, self.output_image(post_options),
                  output_space=self.settings.output_space)

    def export_exr(self, path: str):
        from platinum_tpu_torch.io.exr import write_exr

        write_exr(path, self.readback())

    # Checkpoint / resume: the accumulators are the checkpoint, under the
    # JAX Renderer's keys, so either package's checkpoint loads in the other
    def save_checkpoint(self, path: str):
        np.savez_compressed(
            path, buckets=np.stack([b.cpu().numpy() for b in self._buckets]),
            accumulated=self._accumulated)

    def load_checkpoint(self, path: str):
        data = np.load(path)
        self._buckets = [torch.from_numpy(np.array(b)).to(self.device)
                         for b in data["buckets"]]
        self._accumulated = int(data["accumulated"])
