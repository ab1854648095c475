"""Rank programs of tests/test_torch_parallel.py, one process per rank.

Kept apart from the test module so that a spawned rank imports torch and
the port alone, never JAX. `run(rank, world, store, out_dir)` joins a
gloo group on the CPU through a FileStore, runs every multi-rank check of
the test module in that one group and saves what each rank saw to
out_dir/rank{r}.pt.
"""

import numpy as np
import torch
import torch.distributed as dist

CORNELL = dict(width=16, height=16, spp=4, max_bounces=3, sampler="pcg4d")
SPHERES = dict(CORNELL, tracer="packet")
GMON = dict(CORNELL, spp=4)
COLONNADE = dict(width=16, height=16, spp=2, max_bounces=3, sampler="pcg4d",
                 tracer="packet", partition_tris=800, instancing="off",
                 stream="off")
SMALL_COLONNADE = dict(columns=4, rows=2, sphere_res=(10, 14))


def rays(r=512, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (r, 3)).astype(np.float32)
    d = rng.normal(0, 1, (r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def run(rank, world, store, out_dir):
    from platinum_tpu_torch.app import scenes
    from platinum_tpu_torch.parallel import mesh as M
    from platinum_tpu_torch.parallel.geometry import (
        make_geom_sharded_tracer, render_geom_sharded)
    from platinum_tpu_torch.parallel.shard import (render_sharded,
                                                   render_sharded_gmon)
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import make_tracers
    from platinum_tpu_torch.render.types import RenderSettings

    torch.set_num_threads(1)
    dev = M.join(rank, world, store=dist.FileStore(store, world),
                 device="cpu")
    out = {"backend": dist.get_backend()}
    st = M.make_mesh()                  # sample=2 x tile=2
    out["mesh"] = dict(st.shape)

    def flat_of(scene_cam, kw, **fkw):
        s = RenderSettings(**kw)
        return flatten_scene(*scene_cam, s, device=dev, **fkw), s

    flat, s = flat_of(scenes.make_cornell_scene(), CORNELL)
    feats = analyze_features(flat)
    out["cornell"] = render_sharded(flat, s, st, features=feats)
    out["gmon"] = render_sharded_gmon(flat, RenderSettings(**GMON), st,
                                      cap=1.0, features=feats)
    flat, s = flat_of(scenes.make_spheres_scene(grid=2), SPHERES,
                      accel_min_tris=1)
    out["spheres"] = render_sharded(flat, s, st,
                                    features=analyze_features(flat))

    flat, s = flat_of(scenes.make_colonnade_scene(**SMALL_COLONNADE),
                      COLONNADE, accel_min_tris=1)
    geom = M.mesh_of({"tile": 2, "geom": 2})
    out["geom_coords"] = dict(geom.coords)
    tc, ta = make_geom_sharded_tracer(flat.wbvh_parts, geom)
    sc, sa = make_tracers(flat, s)
    o, d = rays()
    a, b = tc(o, d, 1e-3, float("inf")), sc(o, d, 1e-3, float("inf"))
    out["geom_tracer"] = {k: (getattr(a, k), getattr(b, k))
                          for k in ("t", "tri", "bary", "hit")}
    out["geom_any"] = (ta(o, d, 1e-3, 9.0), sa(o, d, 1e-3, 9.0))
    # each partition twice, the copies on the other geom rank: every hit
    # is an exact tie across ranks, traced again in rank order
    from platinum_tpu_torch.accel.partition import make_partitioned_tracer

    dup = flat.wbvh_parts[:2] * 2
    tc, _ = make_geom_sharded_tracer(dup, geom)
    a = tc(o, d, 1e-3, float("inf"))
    b = make_partitioned_tracer(dup)[0](o, d, 1e-3, float("inf"))
    out["geom_ties"] = ({k: (getattr(a, k), getattr(b, k))
                         for k in ("t", "tri", "bary", "hit")},
                        tc.retraced)
    out["geom_image"] = render_geom_sharded(
        flat, s, M.mesh_of({"sample": 1, "tile": 2, "geom": 2}),
        features=analyze_features(flat))
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()
