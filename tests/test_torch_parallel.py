"""The port's multi-device path (parallel/, the CLI's --mesh, entry.py)
on a gloo group of CPU processes, against single-device renders.

One group of 4 ranks is spawned once for the module (a FileStore under a
temporary directory, no TCP port) and runs every multi-rank check in it
(tests/torch_parallel_ranks.py):
- a sample=2 x tile=2 mesh on Cornell and on the spheres scene through
  the packet tracer (its plain version here): every rank's image within
  1e-5 of the port's single-device render and of JAX's
  integrator.render (the bar of tests/test_multichip.py:47);
- the GMoN mesh (the sample axis as the buckets) within 2e-3 of the
  single-device buckets' gmon_combine, the port's and JAX's (tests/
  test_multichip.py:175);
- geom=2 x tile=2 on the small colonnade in partitions: the geom-sharded
  tracer bit for bit the sequential partitioned one (tests/
  test_multichip.py:231-236), also where every hit ties across ranks
  (partitions duplicated: the rays traced again in rank order), and the
  3-axis step within 1e-5 of the port's single-device render and of
  JAX's integrator.render.
Then, each in its own processes: `render --mesh tile=2 --device cpu`
under torch.distributed.run against the single-device CLI's image, and
entry.dryrun_multichip(4, device="cpu"). multihost.initialize() is a
no-op in one process.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from platinum_tpu.app import scenes as jscenes
from platinum_tpu.ops.gmon import gmon_combine as jgmon_combine
from platinum_tpu.render import integrator as jintegrator
from platinum_tpu.render.flatten import analyze_features as janalyze
from platinum_tpu.render.flatten import flatten_scene as jflatten
from platinum_tpu.render.types import RenderSettings as JSettings
from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.ops.gmon import gmon_combine
from platinum_tpu_torch.parallel import multihost
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.types import RenderSettings

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ATOL = 1e-5          # tests/test_multichip.py:47
GMON_ATOL = 2e-3     # tests/test_multichip.py:175


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """What each of the 4 ranks saved."""
    tmp = tmp_path_factory.mktemp("gloo")
    mp.start_processes(ranks.run, args=(WORLD, str(tmp / "store"), str(tmp)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _single(make, kw, **fkw):
    flat = flatten_scene(*make(), RenderSettings(**kw), device="cpu", **fkw)
    feats = analyze_features(flat)
    return integrator.render(flat, RenderSettings(**kw),
                             features=feats).numpy(), flat, feats


def _jax_render(make, kw, **fkw):
    flat = jflatten(*make(), JSettings(**kw), **fkw)
    return np.asarray(jintegrator.render(flat, JSettings(**kw),
                                         features=janalyze(flat)))


@pytest.mark.parametrize("name", ["cornell", "spheres"])
def test_sample_tile_mesh_is_the_single_device_render(group, name):
    if name == "cornell":
        make, jmake, kw, fkw = (scenes.make_cornell_scene,
                                jscenes.make_cornell_scene, ranks.CORNELL, {})
    else:
        make = lambda: scenes.make_spheres_scene(grid=2)          # noqa: E731
        jmake = lambda: jscenes.make_spheres_scene(grid=2)        # noqa: E731
        kw, fkw = ranks.SPHERES, dict(accel_min_tris=1)
    single, _, _ = _single(make, kw, **fkw)
    ref = _jax_render(jmake, kw, **fkw)
    assert group[0]["backend"] == "gloo"
    assert group[0]["mesh"] == {"sample": 2, "tile": 2}
    for r, out in enumerate(group):
        img = out[name].numpy()
        assert img.shape == single.shape and np.isfinite(img).all()
        assert np.abs(img - single).max() <= ATOL, r
        assert np.abs(img - ref).max() <= ATOL, r
    assert single.mean() > 0.01


def test_gmon_mesh_is_the_bucket_reference(group):
    """The sample axis as GMoN buckets: bucket s holds samples k * 2 + s;
    gmon_combine of the single-device buckets is the reference, the
    port's and JAX's (render_step and gmon_combine of each package)."""
    kw = ranks.GMON
    s, js = RenderSettings(**kw), JSettings(**kw)
    flat = flatten_scene(*scenes.make_cornell_scene(), s, device="cpu")
    jflat = jflatten(*jscenes.make_cornell_scene(), js)
    feats, jfeats = analyze_features(flat), janalyze(jflat)
    buckets, jbuckets = [], []
    for b in range(2):
        acc = torch.zeros((s.num_pixels, 3))
        jacc = jnp.zeros((s.num_pixels, 3))
        for k in range(2):
            acc = integrator.render_step(flat, s, acc, k,
                                         sample_seed=k * 2 + b,
                                         features=feats)
            jacc = jintegrator.render_step(jflat, js, jacc, k,
                                           sample_seed=k * 2 + b,
                                           features=jfeats)
        buckets.append(acc)
        jbuckets.append(jacc)
    ref = gmon_combine(torch.stack(buckets), 2, 1.0).numpy()
    jref = np.asarray(jgmon_combine(jnp.stack(jbuckets), 2, 1.0))
    for out in group:
        img = out["gmon"].numpy().reshape(-1, 3)
        assert np.abs(img - ref).max() <= GMON_ATOL
        assert np.abs(img - jref).max() <= GMON_ATOL


def test_geom_sharded_tracer_is_the_sequential_tracer(group):
    assert {tuple(sorted(o["geom_coords"].items())) for o in group} == {
        (("geom", g), ("tile", t)) for g in (0, 1) for t in (0, 1)}
    for out in group:
        for k, (got, ref) in out["geom_tracer"].items():
            assert torch.equal(got, ref), k
        got, ref = out["geom_any"]
        assert torch.equal(got, ref)
        assert out["geom_tracer"]["hit"][0].sum() > 50


def test_geom_sharded_tracer_retraces_exact_ties_in_rank_order(group):
    """Partitions duplicated across the two geom ranks: every hit ray ties
    exactly across ranks, is traced again from the carried best, and the
    result is the sequential tracer's (the earlier copy wins)."""
    for out in group:
        recs, retraced = out["geom_ties"]
        for k, (got, ref) in recs.items():
            assert torch.equal(got, ref), k
        assert retraced == int(recs["hit"][1].sum()) > 20


def test_geom_sharded_step_is_the_partitioned_render(group):
    """The 3-axis step's image within 1e-5 of the port's single-device
    render and of JAX's integrator.render of the same partitioned
    colonnade."""
    make = lambda: scenes.make_colonnade_scene(                   # noqa: E731
        **ranks.SMALL_COLONNADE)
    jmake = lambda: jscenes.make_colonnade_scene(                 # noqa: E731
        **ranks.SMALL_COLONNADE)
    single, flat, _ = _single(make, ranks.COLONNADE, accel_min_tris=1)
    ref = _jax_render(jmake, ranks.COLONNADE, accel_min_tris=1)
    assert len(flat.wbvh_parts) >= 3
    for out in group:
        img = out["geom_image"].numpy()
        assert np.abs(img - single).max() <= ATOL
        assert np.abs(img - ref).max() <= ATOL
    assert single.max() > 1e-3


def test_multihost_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize(device="cpu") is False
    mesh = multihost.global_mesh()
    assert mesh.shape == {"sample": 1, "tile": 1}
    assert multihost.is_coordinator()


def test_cli_renders_on_a_tile_mesh_under_torchrun(tmp_path):
    """`render cornell --mesh tile=2 --device cpu` in two processes writes
    the image the single-process CLI writes (rank 0 alone writes)."""
    from PIL import Image

    from platinum_tpu_torch.app import cli

    argv = ["render", "cornell", "--spp", "2", "--size", "16x16",
            "--sampler", "pcg4d", "--bounces", "3", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "platinum_tpu_torch.app.cli", *argv,
         "--mesh", "tile=2", "-o", str(mesh_dir / "m.png")],
        cwd=str(mesh_dir), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rendered 2 spp on mesh {'tile': 2} in " in proc.stderr
    assert "2 ranks on gloo" in proc.stderr
    assert sorted(os.listdir(mesh_dir)) == ["m.png"]
    cli.main(argv + ["-o", str(tmp_path / "one.png")])
    a = np.asarray(Image.open(mesh_dir / "m.png"), np.int16)
    b = np.asarray(Image.open(tmp_path / "one.png"), np.int16)
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a - b).max() <= 1


def test_mesh_size_must_match_the_world(tmp_path):
    from platinum_tpu_torch.app import cli

    with pytest.raises(SystemExit, match="needs 2 devices, found 1"):
        cli.main(["render", "cornell", "--spp", "1", "--size", "8x8",
                  "--mesh", "tile=2", "--device", "cpu",
                  "-o", str(tmp_path / "x.png")])


def test_dryrun_multichip_on_four_cpu_ranks(capfd):
    from platinum_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh {'sample': 2, 'tile': 2}" in out
    rows = [ln.split() for ln in out.splitlines()
            if ln.strip()[:1].isdigit()]
    assert [r[0] for r in rows] == ["1", "2", "4"]
    assert all(float(r[-1]) < 2e-3 for r in rows)


def test_entry_returns_one_progressive_step():
    from platinum_tpu_torch.entry import entry

    fn, (flat, accum, idx) = entry(device="cpu")
    out = fn(flat, accum, idx)
    assert out.shape == (64 * 64, 3) and torch.isfinite(out).all()
    assert out.mean() > 0.01
