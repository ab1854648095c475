"""Entry points of the port: a single-device step and a multi-rank
dry run.

Port of __graft_entry__.py. `entry()` returns one progressive render step
on Cornell with its arguments; `dryrun_multichip(n)` spawns n ranks
(torch.distributed over a FileStore in a temporary directory; gloo when
the ranks share a card or run on the CPU, NCCL when each has its own
card) and runs the sharded step on them, then prints the device-count
table. Both run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def entry(*, device="cuda"):
    """(fn, example_args): one progressive render step on the flagship
    path (Cornell at 64x64, the MIS kernel, 4 bounces, pcg4d):
    fn(flat, accum, sample_idx) -> accum."""
    import torch

    from platinum_tpu_torch.app.scenes import make_cornell_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.integrator import render_sample
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_cornell_scene()
    settings = RenderSettings(width=64, height=64, spp=4, max_bounces=4,
                              sampler="pcg4d")
    flat = flatten_scene(scene, cam, settings, device=device)
    accum = torch.zeros((settings.num_pixels, 3),
                        device=flat.camera.position.device)

    def forward_step(flat, accum, sample_idx: int):
        radiance = render_sample(flat, settings, sample_idx)
        k = float(sample_idx)
        return (accum * k + radiance) / (k + 1.0)

    return forward_step, (flat, accum, 0)


def dryrun_multichip(n_devices: int, *, device="cuda") -> None:
    """Spawn n ranks and run the sharded render step twice on the spheres
    scene with the packet tracer on a ("sample", "tile") mesh; with
    n % 8 == 0 also the 3-axis geometry-sharded step on the small
    colonnade; then print the device-count table (ms/spp and the largest
    difference from the one-rank image, 1, 2, 4 and 8 ranks over the same
    8-sample set). Raises if a rank fails."""
    import torch.multiprocessing as mp

    if device != "cpu":
        from platinum_tpu_torch.render.types import resolve_device

        resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, nprocs=n_devices,
                           args=(n_devices, os.path.join(tmp, "store"),
                                 str(device)),
                           start_method="spawn")


def _dryrun_rank(rank: int, n: int, store_path: str, device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from platinum_tpu_torch.app.scenes import (make_colonnade_scene,
                                               make_spheres_scene)
    from platinum_tpu_torch.parallel.mesh import join, make_mesh, mesh_of
    from platinum_tpu_torch.parallel.shard import (gather_image,
                                                   make_sharded_step)
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    if device == "cpu":
        torch.set_num_threads(1)
    dev = join(rank, n, store=dist.FileStore(store_path, n), device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        # the spheres scene through the packet tracer (the kernel on the
        # card, its plain version on the CPU), not the brute tracer
        scene, cam = make_spheres_scene(grid=2)
        settings = RenderSettings(width=32, height=32, spp=4, max_bounces=3,
                                  sampler="pcg4d", tracer="packet")
        flat = flatten_scene(scene, cam, settings, accel_min_tris=1,
                             device=dev)
        assert flat.wbvh_nodes is not None, "packet path must be engaged"
        feats = analyze_features(flat)
        mesh = make_mesh()
        step = make_sharded_step(flat, settings, mesh, features=feats)
        accum = torch.zeros((settings.num_pixels // mesh.shape["tile"], 3),
                            device=dev)
        accum = step(accum, 0)
        accum = step(accum, 1)
        out = gather_image(accum, settings, mesh).cpu().numpy()
        assert out.shape == (settings.height, settings.width, 3)
        assert np.isfinite(out).all()
        mean = float(out.mean())
        assert mean > 0.01, "rendered image should not be black"

        if n % 8 == 0:
            from platinum_tpu_torch.parallel.geometry import (
                make_geom_sharded_step)

            scene3, cam3 = make_colonnade_scene(columns=4, rows=2,
                                                sphere_res=(10, 14))
            s3 = RenderSettings(width=16, height=16, spp=2, max_bounces=3,
                                sampler="pcg4d", tracer="packet",
                                partition_tris=800, instancing="off",
                                stream="off")
            flat3 = flatten_scene(scene3, cam3, s3, accel_min_tris=1,
                                  device=dev)
            assert flat3.wbvh_parts is not None and len(flat3.wbvh_parts) >= 2
            mesh3 = mesh_of({"sample": 2, "tile": n // 4, "geom": 2})
            step3 = make_geom_sharded_step(flat3, s3, mesh3,
                                           features=analyze_features(flat3))
            acc3 = step3(torch.zeros((s3.num_pixels // (n // 4), 3),
                                     device=dev), 0)
            out3 = acc3.cpu().numpy()
            assert np.isfinite(out3).all()
            say(f"geom-sharded step OK: mesh {mesh3.shape}, parts "
                f"{len(flat3.wbvh_parts)}, mean of rank 0's tile "
                f"{out3.mean():.4f}", flush=True)

        _device_table(scene, cam, settings, n, dev, say)
        say(f"dryrun_multichip OK: mesh {mesh.shape}, mean {mean:.4f}",
            flush=True)
    finally:
        dist.destroy_process_group()


def _device_table(scene, cam, settings, n, dev, say):
    """Per-step wall time and equality with the one-rank render at 1, 2,
    4 and 8 ranks (those of them <= n), each over the same 8 samples.
    Ranks that share one host's cores or one card time-slice them, so the
    times measure the sharding and collective overhead, not a speed-up;
    equality is the check."""
    import numpy as np
    import torch

    from platinum_tpu_torch.parallel.mesh import make_mesh
    from platinum_tpu_torch.parallel.shard import (gather_image,
                                                   make_sharded_step)
    from platinum_tpu_torch.render.flatten import flatten_scene

    total_spp = 8
    ref = None
    rows = []
    for d in (1, 2, 4, 8):
        if d > n:
            continue
        ns = 2 if d % 2 == 0 else 1
        mesh = make_mesh(sample_parallel=ns, ranks=range(d))
        if mesh is None:            # this rank sits the row out
            continue
        flat = flatten_scene(scene, cam, settings, accel_min_tris=1,
                             device=dev)
        step = make_sharded_step(flat, settings, mesh)
        acc = torch.zeros((settings.num_pixels // mesh.shape["tile"], 3),
                          device=dev)
        n_steps = total_spp // ns
        acc = step(acc, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(1, n_steps):
            acc = step(acc, i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) / max((n_steps - 1) * ns, 1) * 1e3
        img = gather_image(acc, settings, mesh).cpu().numpy()
        ref = img if ref is None else ref
        err = float(np.abs(img - ref).max())
        assert np.isfinite(img).all()
        # the same sample sets; only the mean's summation order may differ
        assert err < 2e-3, (d, err)
        rows.append((d, ns, d // ns, ms, err))
    say("device-count table (ranks share this host's cores or one card: "
        "overhead and equality, not speed-up; the same 8-sample sets):")
    say("  ranks  mesh(SxT)  ms/spp  maxerr_vs_1rank")
    for d, ns, nt, ms, err in rows:
        say(f"  {d:5d}  {ns}x{nt:<7d}  {ms:7.1f}  {err:.2e}")
    sys.stdout.flush()
