"""A mesh of ranks for multi-device rendering over torch.distributed.

Port of platinum_tpu/parallel/mesh.py. The JAX package lays its devices
out as a `jax.sharding.Mesh` with named axes and lets XLA insert the
collectives. Here every rank is one process driving one device, and the
mesh is the ranks laid out row-major over named axes:

  tile   pixels sharded across ranks; each rank traces its pixels
         against the replicated scene.
  sample spp sharded across ranks; deterministic, because the samplers
         are counter-based in (pixel, sample); the accumulators combine
         with a mean (an all-reduce over the axis).
  geom   the scene's partitions spread across ranks (parallel/geometry.py).

Each axis has one process subgroup per axis line (the ranks along that
axis, the other coordinates fixed); `Mesh.group(axis)` is this rank's.

This module alone holds three things the multi-device path rests on:

- the collective helpers (`all_reduce_sum`, `all_reduce_mean`,
  `all_gather` over an axis). On NCCL the tensors stay on the card. On
  gloo they are copied to the host for the collective and back, always
  (chip_smoke.py phase 8c records which collectives the installed gloo
  takes on CUDA tensors); the render itself never leaves the device;
- the device of each rank, `cuda:{local_rank % device_count}`
  (`rank_device`);
- the backend rule (`choose_backend`): NCCL where every local rank has a
  card of its own, gloo otherwise. NCCL refuses two ranks on one card, so
  ranks that share a card run on gloo.

There is no `replicate`: every rank flattens the same scene, which gives
the same arrays, straight onto its own device (`flatten_scene(...,
device=rank_device(...))`), so nothing of the scene crosses between
ranks.
"""

from __future__ import annotations

import datetime
import sys
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this has lost a rank: fail, not hang
TIMEOUT = datetime.timedelta(seconds=600)


def choose_backend(device, local_world_size: int) -> str:
    """NCCL when the ranks run on the card and each local rank has a card
    of its own; gloo otherwise (the CPU, or ranks sharing a card)."""
    if (torch.device(device).type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world_size):
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The device a rank renders on: `cuda:{local_rank % device_count}`
    on the card (raising where there is none), the CPU when asked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: platinum_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def join(rank: int, world_size: int, *, store=None, init_method=None,
         device="cuda", local_rank: int | None = None,
         local_world_size: int | None = None) -> torch.device:
    """Join the default process group as `rank` of `world_size` (by a
    `store`, e.g. a FileStore, or an `init_method` such as "env://") with
    the backend `choose_backend` picks. Prints the choice; returns this
    rank's device."""
    local_rank = rank if local_rank is None else local_rank
    local_world_size = (world_size if local_world_size is None
                        else local_world_size)
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(store=store) if store is not None else dict(
        init_method=init_method or "env://")
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=TIMEOUT, **kw)
    if rank == 0:
        print(f"torch.distributed: {world_size} ranks on {backend} "
              f"({local_world_size} a host, {torch.cuda.device_count()} "
              f"CUDA devices here)", file=sys.stderr, flush=True)
    return dev


@dataclass
class Mesh:
    """Named axes over ranks. `shape` maps each axis to its size in the
    mesh's axis order; `coords` is this rank's coordinate on each axis;
    `groups` this rank's subgroup per axis. Without a process group (one
    process) there are none, and a collective is the identity; with one,
    a size-1 axis has its one-rank groups too, so the collectives run
    through the backend (a one-rank NCCL group exercises NCCL)."""

    shape: dict
    coords: dict
    groups: dict = field(default_factory=dict)
    backend: str | None = None

    def group(self, axis: str):
        return self.groups.get(axis)


def mesh_of(axes: dict, ranks=None) -> Mesh | None:
    """A mesh of the named `axes` ({name: size}, in order) over `ranks`
    (default: every rank of the default group, or the one process when
    there is no group), laid out row-major. Every rank must call this,
    also one outside `ranks` (it gets None): `new_group` is collective
    over the whole world, for every line of every axis, in one order."""
    axes = {str(a): int(n) for a, n in axes.items()}
    sizes = tuple(axes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = tuple(range(world) if ranks is None else ranks)
    if int(np.prod(sizes, dtype=np.int64)) != len(ranks):
        raise ValueError(f"mesh {axes} needs {int(np.prod(sizes))} ranks, "
                         f"given {len(ranks)}")
    grid = np.asarray(ranks, np.int64).reshape(sizes)
    groups = {}
    for ai, name in enumerate(axes if dist.is_initialized() else ()):
        # every line along this axis, the other coordinates fixed
        for line in np.moveaxis(grid, ai, -1).reshape(-1, sizes[ai]):
            g = dist.new_group(ranks=[int(r) for r in line])
            if me in line:
                groups[name] = g
    if me not in ranks:
        return None
    where = np.argwhere(grid == me)[0]
    return Mesh(shape=axes,
                coords={a: int(c) for a, c in zip(axes, where)},
                groups=groups,
                backend=dist.get_backend() if dist.is_initialized() else None)


def make_mesh(axes=("sample", "tile"), sample_parallel=None, ranks=None
              ) -> Mesh | None:
    """1D or 2D mesh over `ranks` (default every rank), the JAX
    make_mesh's rule: a 2D ("sample", "tile") mesh gives the sample axis
    the largest power-of-two factor of the rank count up to
    `sample_parallel` (default: up to n // 2, so both axes are populated
    when n > 1) and the tile axis the rest. sample_parallel=1 gives a pure
    tile mesh, sample_parallel=n a pure sample mesh."""
    n = (len(ranks) if ranks is not None
         else dist.get_world_size() if dist.is_initialized() else 1)
    if len(axes) == 1:
        shape = (n,)
    else:
        limit = max(1, min(n, sample_parallel if sample_parallel else n // 2))
        s = 1
        while s * 2 <= limit and n % (s * 2) == 0:
            s *= 2
        shape = (s, n // s)
    return mesh_of(dict(zip(axes, shape)), ranks)


def _host_copy(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of `x` over the ranks of this rank's `axis` line (a new
    tensor; every rank of the line gets the same bits)."""
    g = mesh.group(axis)
    if g is None:
        return x
    buf = x.detach().cpu() if _host_copy(mesh, x) else x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=g)
    return buf.to(x.device)


def all_reduce_mean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean of `x` over this rank's `axis` line (JAX `pmean`)."""
    return all_reduce_sum(x, mesh, axis) / float(mesh.shape.get(axis, 1))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): `x` from each rank of this rank's `axis` line, in
    axis order (JAX `all_gather`)."""
    g = mesh.group(axis)
    if g is None:
        return x[None]
    host = _host_copy(mesh, x)
    src = x.detach().cpu() if host else x.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, src, group=g)
    return torch.stack(out).to(x.device)

