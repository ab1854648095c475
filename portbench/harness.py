"""One run of one cell: set-up, warm step, the measured window, the traced
stretches of a `--trace 1` run, and the comparison with the reference.

Everything a cell needs is found by name: the cell in BENCHMARK.json
names a configuration (its `file`, with the scene generator, the
RenderSettings, the sizes and, optionally, `"reference"`) and a traffic
mix (traffic/<traffic>.json: the image size and whether every frame is
displayed); the scene comes from the generator (scenes.py's GENERATORS
or generators/<name>.py), the plain reference is
reference/<reference>.py (default `pathtracer`), the comparison's
tolerances and limits are in checks/<cell>.json, and each per-layer
metric is read by metrics/<metric>.py. A new cell, even of a scene with
textures and an environment, is new files and a new entry; nothing here
names a cell, a configuration or a metric.

The loop is closed: a step starts once the last has returned. A final
render runs `Renderer.render()` steps back to back; a displaying mix
(the progressive viewport) follows each step with `output_image()`, the
post stack with the display image on the host, and times each frame from
its step's start to that image.

The seed picks the window's samples: after the warm step (sample 0) the
Renderer is handed its own accumulator back through `load_checkpoint` as
if `s0 = 1 + seed % FIRST_SAMPLES` samples were in it, so the window
renders samples s0, s0 + 1, ... (the Renderer's sample index is its
sample count). The seed also draws the pixels the comparison reads.
"""

from __future__ import annotations

import gc
import io
import json
import os
import sys
import time

import numpy as np

from portbench import compare, profiling, scenes

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FIRST_SAMPLES = 64
PLAIN_SECONDS = 2.0     # the plain stretch that counts rays
PROFILED_STEPS = 2      # steps (frames) under the profiler
FORBIDDEN = ("jax", "jaxlib", "flax", "platinum_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration file, traffic mix, check file,
    metric lists, generators' folder and reference module, all found by
    name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "portbench")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    config = load_json(os.path.join(root, cfg["file"]))
    return dict(
        cell=cell, config=config,
        traffic=load_json(os.path.join(here, "traffic",
                                       cell["traffic"] + ".json")),
        check=load_json(os.path.join(here, "checks", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        metrics_dir=os.path.join(here, "metrics"),
        generators_dir=os.path.join(here, "generators"),
        reference=scenes.load_file(
            os.path.join(here, "reference",
                         config.get("reference", "pathtracer") + ".py"),
            "portbench_reference_"))


def reader(metrics_dir: str, name: str):
    """metrics/<name>.py's `read`."""
    return scenes.load_file(os.path.join(metrics_dir, name + ".py"),
                            "portbench_metric_").read


def port_scene(arrays: dict):
    """The program's Scene (and camera node) of the generator's arrays,
    built through its public API (scenes.py lists the keys)."""
    from platinum_tpu_torch.core.camera import Camera
    from platinum_tpu_torch.core.material import Material, TextureSlot
    from platinum_tpu_torch.core.mesh import Mesh
    from platinum_tpu_torch.core.scene import Scene
    from platinum_tpu_torch.core.texture import Texture, TextureFormat
    from platinum_tpu_torch.core.transform import Transform

    scene = Scene()
    mesh_ids = {k: scene.add_asset(Mesh(m["positions"], m["indices"],
                                        m["normals"], m["tangents"], m["uvs"],
                                        name=k), retained=True)
                for k, m in arrays["meshes"].items()}
    tex_ids = {k: scene.add_asset(Texture(data=t["data"],
                                          format=TextureFormat(t["format"]),
                                          name=k), retained=True)
               for k, t in arrays.get("textures", {}).items()}

    def material(name, keys):
        keys = dict(keys)
        slots = keys.pop("textures", {})
        return Material(name=name, **keys, textures={
            TextureSlot[slot.upper()]: tex_ids[t] for slot, t in slots.items()})

    mat_ids = {k: scene.add_asset(material(k, v))
               for k, v in arrays["materials"].items()}
    for name, mesh, mat, t, r, s in arrays["instances"]:
        node = scene.create_node(name)
        scene.set_mesh(node.id, mesh_ids[mesh])
        scene.set_material(node.id, 0, mat_ids[mat])
        node.transform = Transform(translation=t, rotation=r, scale=s)
    c = arrays["camera"]
    cam = scene.create_node("camera")
    cam.camera = Camera.with_focal_length(c["focal_length"],
                                          sensor_size=tuple(c["sensor_size"]))
    cam.camera.focus_distance = c["focus_distance"]
    cam.transform = Transform(translation=c["position"], target=c["target"],
                              track=True)
    if "environment" in arrays:
        e = arrays["environment"]
        env = scene.environment
        env.constant_color = tuple(e["constant_color"])
        env.strength = e["strength"]
        if e.get("texture") is not None:
            tid = tex_ids[e["texture"]]
            env.set_texture(tid, scene.asset(tid).as_float_rgba())
    return scene, cam.id


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        root: str = ROOT) -> dict:
    """The result line of one run; raises on a fault of the run itself
    (not on a wrong answer, which `correct` reports)."""
    import torch

    from platinum_tpu_torch.render.renderer import Renderer
    from platinum_tpu_torch.render.types import RenderSettings

    t0 = time.perf_counter() if t_start is None else t_start
    spec = find_cell(bench, name, root)
    traffic, config, check = spec["traffic"], spec["config"], spec["check"]
    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    arrays = scenes.make(config, spec["generators_dir"])
    settings = RenderSettings(width=traffic["width"],
                              height=traffic["height"], spp=1 << 30,
                              **config["settings"])
    scene, cam = port_scene(arrays)
    r = Renderer(scene, device=device)
    r.start_render(cam, settings)
    display = bool(traffic["display"])
    r.render()                                  # warm step: sample 0
    if display:
        r.output_image()
    first = 1 + seed % FIRST_SAMPLES
    buf = io.BytesIO()
    np.savez(buf, buckets=r.readback().reshape(1, -1, 3), accumulated=first)
    buf.seek(0)
    r.load_checkpoint(buf)
    sync()
    setup_s = time.perf_counter() - t0

    frames, post_spans, img = [], [], None
    steps = 0
    w0 = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        r.render()
        if display:
            if trace:
                sync()
                p0 = time.perf_counter()
                img = r.output_image()
                post_spans.append(time.perf_counter() - p0)
            else:
                img = r.output_image()
            frames.append(time.perf_counter() - f0)
        steps += 1
        if time.perf_counter() - w0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - w0
    values = dict(setup_s=setup_s, ms_per_spp=window_s * 1e3 / steps)
    if frames:
        values["frame_ms_p90"] = float(np.percentile(frames, 90)) * 1e3

    if trace:
        rec = _traced(r, sync, first + steps, display, post_spans)
        steps += rec["spp"]
        if display:
            img = rec.pop("img")
        rec["kind"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        rec["triangles"] = int(r.flat.geometry.indices.shape[0])

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    acc_prog = r.readback().reshape(-1, 3)
    n_lights = int(r.flat.lights.count)
    lights = r.flat.lights.packed[:n_lights, :9].cpu().numpy()
    del r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref0 = time.perf_counter()
    pixels = compare.draw_pixels(seed, settings.num_pixels, check["pixels"])
    acc_ref, disp_ref, light_gap = compare.reference_image(
        spec["reference"], arrays, dict(width=settings.width, height=settings.height,
                     max_bounces=settings.max_bounces),
        pixels, first, steps, lights, device)
    disp_prog = (np.asarray(img).reshape(-1, 3)[pixels] if display
                 else None)
    nums = compare.numbers(
        check, acc_prog[pixels], acc_ref.cpu().numpy(), disp_prog,
        disp_ref.cpu().numpy() if display else None, light_gap)
    table, correct = compare.judge(check, nums)
    print(f"portbench: set-up {setup_s:.2f} s, window {window_s:.2f} s over "
          f"{steps} steps from sample {first}, "
          f"reference {time.perf_counter() - ref0:.2f} s over "
          f"{len(pixels)} pixels", file=sys.stderr, flush=True)

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=spec["cell"]["chips"], memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=steps, failed=0)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(spec["metrics_dir"], m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev.update(busy_s=rec["profile"]["busy_s"],
                   window_s=rec["profile"]["window_s"])
        out.update(metrics=metrics, device=dev, breakdown=dict(
            device_ops=rec["profile"]["device_ops"],
            idle_gaps=rec["profile"]["idle_gaps"]))
    else:
        out.update(metrics={m["name"]: dict(value=values[m["name"]],
                                            unit=m["unit"])
                            for m in spec["end_to_end"]},
                   device=dev)
    out["checks"] = table
    return out


def _traced(r, sync, next_sample, display, post_spans):
    """The per-layer record: rays over a plain stretch of render_sample
    calls (the accumulator untouched), then PROFILED_STEPS steps of the
    cell's own loop under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import analyze_features

    tracers = integrator.make_tracers(r.flat, r.settings)
    feats = analyze_features(r.flat)
    rays = None
    n = 0
    sync()
    p0 = time.perf_counter()
    while n < 2 or time.perf_counter() - p0 < PLAIN_SECONDS:
        _, k = integrator.render_sample(r.flat, r.settings, next_sample + n,
                                        tracers=tracers, return_stats=True,
                                        features=feats)
        rays = k if rays is None else rays + k
        n += 1
    sync()
    plain_s = time.perf_counter() - p0
    del tracers
    img = None
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(profiling.WINDOW):
            for _ in range(PROFILED_STEPS):
                r.render()
                if display:
                    img = r.output_image()
            sync()
    device, host = profiling.from_profiler(prof)
    summary = profiling.summarize(device, host, profiling.trace_patterns())
    return dict(spp=PROFILED_STEPS, rays=float(rays), plain_s=plain_s,
                plain_spp=n, profile=summary, post_spans=post_spans, img=img)
