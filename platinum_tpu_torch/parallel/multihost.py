"""Multi-host orchestration of the multi-device render.

Port of platinum_tpu/parallel/multihost.py. Every host runs the same
program under `torchrun` (`python -m torch.distributed.run`), which sets
the standard environment: WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR and MASTER_PORT. `initialize()` joins the process group from
it (parallel/mesh.py `join`: the backend rule, the rank's device);
`global_mesh()` lays every rank out as ("sample", "tile") with the
host-crossing axis outermost on "sample" (spp shards combine once a
progressive step, so the slow link between hosts carries one all-reduce a
step while each "tile" row stays inside one host); the render steps of
parallel/shard.py run on it unchanged. Only the coordinator writes files.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from platinum_tpu_torch.parallel.mesh import Mesh, join, mesh_of


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda") -> bool:
    """Join the process group (a no-op returning False for one process).

    The arguments default to torchrun's WORLD_SIZE and RANK; the
    coordinator ("host:port") to MASTER_ADDR:MASTER_PORT. Returns True
    when running multi-process."""
    num = (num_processes if num_processes is not None
           else int(os.environ.get("WORLD_SIZE", "1")))
    if num <= 1 or dist.is_initialized():
        return dist.is_initialized()
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    join(rank, num,
         init_method=(f"tcp://{coordinator_address}" if coordinator_address
                      else "env://"),
         device=device,
         local_rank=int(os.environ.get("LOCAL_RANK", rank)),
         local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", num)))
    return True


def global_mesh(sample_axis: int | None = None) -> Mesh:
    """("sample", "tile") mesh over every rank, the host-crossing
    boundary on "sample": torchrun numbers ranks host by host, so
    (hosts * k, local // k) keeps every "tile" row inside one host."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    hosts = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if sample_axis is None:
        sample_axis = hosts if hosts > 1 else (2 if n % 2 == 0 else 1)
    if n % sample_axis:
        raise ValueError(f"{n} ranks not divisible by sample={sample_axis}")
    return mesh_of({"sample": sample_axis, "tile": n // sample_axis})


def is_coordinator() -> bool:
    """True on the process that writes outputs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def render_multihost(flat, settings, features=None, mesh: Mesh | None = None):
    """Render across every rank on the global mesh. Every rank returns the
    full (H, W, 3) image; write it only from is_coordinator()."""
    from platinum_tpu_torch.parallel.shard import render_sharded

    if features is None:
        from platinum_tpu_torch.render.flatten import analyze_features

        features = analyze_features(flat)
    return render_sharded(flat, settings, mesh or global_mesh(),
                          features=features)
