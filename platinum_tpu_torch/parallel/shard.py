"""Sharded progressive rendering: tile x sample parallelism over ranks.

Port of platinum_tpu/parallel/shard.py. On a mesh (parallel/mesh.py) with
a "sample" axis (spp sharding: each rank of a sample line traces other
sample indices; they combine with a mean over the axis) and a "tile" axis
(pixel sharding against the replicated scene), rank (s, t) renders sample
step * S + s of the pixels [t * P/T, (t + 1) * P/T) through
`render_sample(pixel_ids=)`. The samplers are counter-based, so these are
the numbers one device would produce sequentially. An absent axis has
size 1. The full image is gathered over "tile" at the end; every rank
returns it, as the JAX package's replicated result is, and only the
coordinator writes files.
"""

from __future__ import annotations

import torch

from platinum_tpu_torch.models import bsdf as _bsdf
from platinum_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                              all_reduce_mean)
from platinum_tpu_torch.render.integrator import make_tracers, render_sample
from platinum_tpu_torch.render.types import FlatScene, RenderSettings


def _shard(settings: RenderSettings, mesh: Mesh, device):
    """(S, this rank's sample coordinate, its pixel ids)."""
    n_sample = mesh.shape.get("sample", 1)
    n_tile = mesh.shape.get("tile", 1)
    if settings.num_pixels % n_tile:
        raise ValueError(f"num_pixels {settings.num_pixels} not divisible "
                         f"by tile axis {n_tile}")
    shard_px = settings.num_pixels // n_tile
    t = mesh.coords.get("tile", 0)
    pixel_ids = t * shard_px + torch.arange(shard_px, device=device)
    return n_sample, mesh.coords.get("sample", 0), pixel_ids


def make_sharded_step(flat: FlatScene, settings: RenderSettings, mesh: Mesh,
                      features: frozenset | None = None, tracers=None):
    """step(accum, step_idx) -> accum: this rank's (P/T, 3) accumulator
    advanced by S = mesh.shape["sample"] samples per pixel (the mean over
    the sample line, then the running mean). The tracer pair is built
    once, here, unless `tracers` is given. Unlike the JAX step, which
    takes the scene as an argument, this one is bound to `flat`."""
    dev = flat.camera.position.device
    n_sample, s, pixel_ids = _shard(settings, mesh, dev)
    feats = features if features is not None else _bsdf.ALL_FEATURES
    tracers = tracers or make_tracers(flat, settings)

    def step(accum, step_idx: int):
        radiance = render_sample(flat, settings, step_idx * n_sample + s,
                                 pixel_ids=pixel_ids, tracers=tracers,
                                 features=feats)
        radiance = all_reduce_mean(radiance, mesh, "sample")
        k = float(step_idx)
        return (accum * k + radiance) / (k + 1.0)

    return step


def gather_image(shard: torch.Tensor, settings: RenderSettings, mesh: Mesh):
    """(H, W, 3): every rank's (P/T, 3) pixels gathered over "tile"."""
    full = all_gather(shard, mesh, "tile").reshape(-1, 3)
    return full.reshape(settings.height, settings.width, 3)


def render_sharded(flat: FlatScene, settings: RenderSettings, mesh: Mesh,
                   steps: int | None = None,
                   features: frozenset | None = None) -> torch.Tensor:
    """Render settings.spp samples across the mesh; returns (H, W, 3) on
    every rank."""
    n_sample = mesh.shape.get("sample", 1)
    steps = steps if steps is not None else -(-settings.spp // n_sample)
    step = make_sharded_step(flat, settings, mesh, features=features)
    n_tile = mesh.shape.get("tile", 1)
    accum = torch.zeros((settings.num_pixels // n_tile, 3),
                        device=flat.camera.position.device)
    for i in range(steps):
        accum = step(accum, i)
    return gather_image(accum, settings, mesh)


def make_sharded_gmon_step(flat: FlatScene, settings: RenderSettings,
                           mesh: Mesh, features: frozenset | None = None,
                           tracers=None):
    """GMoN-bucketed step: the "sample" axis is the bucket axis. Each rank
    keeps its own (P/T, 3) accumulator, with no mean across the axis, so
    after N steps rank s holds bucket s's running mean of samples
    {step * S + s}: step(bucket, step_idx) -> bucket. Combine with
    `combine_buckets` at readback."""
    dev = flat.camera.position.device
    n_sample, s, pixel_ids = _shard(settings, mesh, dev)
    feats = features if features is not None else _bsdf.ALL_FEATURES
    tracers = tracers or make_tracers(flat, settings)

    def step(bucket, step_idx: int):
        radiance = render_sample(flat, settings, step_idx * n_sample + s,
                                 pixel_ids=pixel_ids, tracers=tracers,
                                 features=feats)
        k = float(step_idx)
        return (bucket * k + radiance) / (k + 1.0)

    return step


def combine_buckets(bucket: torch.Tensor, mesh: Mesh,
                    cap: float = 1.0) -> torch.Tensor:
    """This tile's (P/T, 3) GMoN estimate: the buckets gathered over
    "sample" and combined by ops/gmon.py's gmon_combine."""
    from platinum_tpu_torch.ops.gmon import gmon_combine

    buckets = all_gather(bucket, mesh, "sample")
    return gmon_combine(buckets, buckets.shape[0], cap)


def render_sharded_gmon(flat: FlatScene, settings: RenderSettings,
                        mesh: Mesh, steps: int | None = None,
                        cap: float = 1.0,
                        features: frozenset | None = None) -> torch.Tensor:
    """GMoN render across the mesh: the sample-axis ranks are the buckets,
    combined by the firefly-robust median of means at the end; returns
    (H, W, 3) on every rank."""
    n_sample = mesh.shape.get("sample", 1)
    steps = steps if steps is not None else -(-settings.spp // n_sample)
    step = make_sharded_gmon_step(flat, settings, mesh, features=features)
    n_tile = mesh.shape.get("tile", 1)
    bucket = torch.zeros((settings.num_pixels // n_tile, 3),
                         device=flat.camera.position.device)
    for i in range(steps):
        bucket = step(bucket, i)
    return gather_image(combine_buckets(bucket, mesh, cap), settings, mesh)
