"""One benchmark cell of `portbench/` run with the port's own spans and
counters on (platinum_tpu_torch/utils/telemetry.py), drained phase by
phase, on the GPU.

    python3 tools/torch_trace_cell.py --workload sponza_class.final_1080p \
        --seed 3037000493 --seconds 20 [--tracing 0] [--gather-sites N]
        [--out F]

The phases are the harness's (portbench/harness.py): set-up (scene,
`Renderer.start_render`, a warm step, the resume at sample
1 + seed % 64), a closed-loop window of `--seconds` of `render()` steps
(`ms_per_spp`), a plain stretch of `render_sample(...,
return_stats=True)` calls outside the profiler, then two steps under
torch.profiler. Tracing is on from before the Renderer is built and the
records are drained after each phase. Prints one JSON line: the card and
its power limit, set-up by part, `ms_per_spp` over the window, span
totals per phase (count, total and self ms), the counters, the
span and counter readings (setup.flatten_s, setup.tracer_build_s,
setup.autoplan_s, integrator.sync_sites_per_spp, integrator.live_lane_pct,
dispatch.shade_host_ms_per_spp, dispatch.trace_host_ms_per_spp,
integrator.graph_bounce_pct: the profiled window's bounces replayed as
CUDA graphs, `integrator.bounce_graph` spans, over all its bounces; and
where the scene has a sky or textures, setup.env_table_s and
setup.atlas_s, the spans of the sky's alias table and of the atlas,
integrator.env_escape_pct, the profiled window's lanes that took the
sky over its wave lanes, and integrator.texture_taps_per_spp;
integrator.bsdf_kernel_pct, the profiled window's lanes the BSDF kernel
shaded, `bsdf.kernel_lanes`, over the lanes `bsdf.sample` and
`bsdf.evaluate` were given, `bsdf.lanes`; integrator.hit_fetch_kernel_pct,
the lanes the hit-fetch kernel fetched, `hitfetch.kernel_lanes`, over the
lanes `fetch_hit` was given, `hitfetch.lanes`; and where the scene has
cutouts, integrator.alpha_pass_pct, the hits drawn for in the alpha
loops that passed through, `integrator.alpha_passed` over
`integrator.alpha_tested`, integrator.alpha_budget_out_pct, the lanes
out of the hop budget, `integrator.alpha_budget_out`, over the wave
lanes), the
profiler's launches and synchronising calls over the same two steps, the
synchronising calls by the innermost program span they were made in, and
the ten longest device idle gaps, each named by the innermost program
span and the innermost operator at its middle.

`--gather-sites N` adds N eager steps (`render_sample` without the
graphs, the same operations) under torch.profiler with a range around
each call site of the shaded bounce that gathers rows (`fetch_hit`,
`interpolate_hit`, `make_shading_context`, the light and sky samplers,
the normal map, compaction, ...), and prints `gather_sites`: the device
ms a spp of PyTorch's row-gather kernels (`vectorized_gather`, and
`index_elementwise` for 1-D and odd-width gathers) by the innermost site
or program span that launched them, and `trace_sites`: the device ms a
spp of the trace kernels (portbench/trace_kernels.txt) by the innermost
program span that launched them (`integrator.alpha_hops` and
`integrator.alpha_shadow` hold the alpha waves).

`--tracing 0` runs set-up and the window alone with tracing off.
`--turns N` measures the cost of tracing: after a set-up with tracing
off, 2N windows of `--seconds` in one process, tracing off and on in
turns (off, on, on, off, ...), each with its `ms_per_spp`. Needs a CUDA
device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_SECONDS = 2.0
PROFILED_STEPS = 2
TRACE_SPANS = ("integrator.trace_closest", "integrator.trace_shadow")


def _span_ms(spans, names) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] in names) * 1e-6


def readings(setup, plain, profiled) -> dict:
    """The readings of three drains: set-up, the plain stretch (with
    `plain_spp` samples) and the profiled window (with `spp`); a reading
    whose span or counter was not recorded is left out."""
    out = {}
    for key, name in (("setup.flatten_s", "renderer.flatten"),
                      ("setup.tracer_build_s", "renderer.tracers"),
                      ("setup.autoplan_s", "renderer.autoplan"),
                      ("setup.env_table_s", "renderer.env_table"),
                      ("setup.atlas_s", "renderer.atlas")):
        if any(s["name"] == name for s in setup["spans"]):
            out[key] = _span_ms(setup["spans"], (name,)) * 1e-3
    c = profiled["counters"]
    out["integrator.sync_sites_per_spp"] = sum(
        v for k, v in c.items() if k.startswith("sync.")) / profiled["spp"]
    replays = c.get("integrator.graph_replays", 0)
    bounces = replays + sum(1 for s in profiled["spans"]
                            if s["name"] == "integrator.bounce")
    if bounces:
        out["integrator.graph_bounce_pct"] = 100.0 * replays / bounces
    if "integrator.env_escapes" in c and c.get("integrator.wave_lanes"):
        out["integrator.env_escape_pct"] = (
            100.0 * c["integrator.env_escapes"] / c["integrator.wave_lanes"])
    if c.get("integrator.texture_taps"):
        out["integrator.texture_taps_per_spp"] = (
            c["integrator.texture_taps"] / profiled["spp"])
    if c.get("bsdf.lanes"):
        out["integrator.bsdf_kernel_pct"] = (
            100.0 * c.get("bsdf.kernel_lanes", 0) / c["bsdf.lanes"])
    if c.get("hitfetch.lanes"):
        out["integrator.hit_fetch_kernel_pct"] = (
            100.0 * c.get("hitfetch.kernel_lanes", 0) / c["hitfetch.lanes"])
    if c.get("integrator.alpha_tested"):
        out["integrator.alpha_pass_pct"] = (
            100.0 * c.get("integrator.alpha_passed", 0)
            / c["integrator.alpha_tested"])
    if "integrator.alpha_budget_out" in c and c.get("integrator.wave_lanes"):
        out["integrator.alpha_budget_out_pct"] = (
            100.0 * c["integrator.alpha_budget_out"]
            / c["integrator.wave_lanes"])
    c = plain["counters"]
    if c.get("integrator.wave_lanes"):
        out["integrator.live_lane_pct"] = (
            100.0 * c["integrator.live_lanes"] / c["integrator.wave_lanes"])
    n = plain["plain_spp"]
    out["dispatch.shade_host_ms_per_spp"] = _span_ms(
        plain["spans"], ("integrator.shade",)) / n
    out["dispatch.trace_host_ms_per_spp"] = _span_ms(
        plain["spans"], TRACE_SPANS) / n
    return out


def name_gaps(device, host, span_names, window, top: int = 10) -> list:
    """The `top` longest device idle gaps of the window, each named
    "<innermost program span> / <innermost other host event>" at its
    middle (portbench/profiling.py's rule for the second part)."""
    from portbench import profiling

    w0, w1 = window
    busy = profiling._union([(max(s, w0), min(e, w1)) for _, s, e in device
                             if e > w0 and s < w1])
    edges = [[w0, w0]] + busy + [[w1, w1]]
    gaps = sorted(((a[1], b[0]) for a, b in zip(edges, edges[1:])
                   if b[0] > a[1]), key=lambda g: g[0] - g[1])[:top]
    calls = [(n, s, e) for n, s, e in host
             if w0 <= s <= w1 and n != profiling.WINDOW]
    out = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        cover = [(e - s, n) for n, s, e in calls if s <= mid <= e]
        spans = [c for c in cover if c[1] in span_names]
        ops = [c for c in cover if c[1] not in span_names]
        name = " / ".join(x for x in (min(spans)[1] if spans else None,
                                      min(ops)[1] if ops else None) if x)
        out.append([name or "python (no operator)", (g1 - g0) * 1e-6])
    return out


def syncs_by_span(host, span_names, window) -> dict:
    """{innermost program span: count} of the synchronising runtime calls
    (portbench/profiling.py's SYNCS) made inside the window."""
    from portbench import profiling

    w0, w1 = window
    spans = [(e - s, n, s, e) for n, s, e in host if n in span_names]
    out = collections.Counter()
    for n, s, _ in host:
        if n in profiling.SYNCS and w0 <= s <= w1:
            cover = [c for c in spans if c[2] <= s <= c[3]]
            out[min(cover)[1] if cover else "(no span)"] += 1
    return dict(out.most_common())


# (module, attribute, site) of the shaded bounce's calls that gather
# rows; an attribute the program lacks is skipped, so that one tool
# splits two versions of it
GATHER_SITES = (
    ("platinum_tpu_torch.render.integrator", "fetch_hit", "fetch_hit"),
    ("platinum_tpu_torch.render.integrator", "interpolate_hit",
     "interpolate_hit"),
    ("platinum_tpu_torch.models.bsdf", "make_shading_context",
     "make_shading_context"),
    ("platinum_tpu_torch.models.bsdf", "sample_material_textures",
     "material_textures"),
    ("platinum_tpu_torch.models.lights", "sample_area_light",
     "sample_area_light"),
    ("platinum_tpu_torch.models.lights", "sample_env_light",
     "sample_env_light"),
    ("platinum_tpu_torch.render.integrator", "_apply_normal_map",
     "normal_map"),
    ("platinum_tpu_torch.render.integrator", "_picked_emission",
     "picked_emission"),
    ("platinum_tpu_torch.render.integrator", "_compact_state",
     "compaction"))
GATHER_KERNELS = ("vectorized_gather", "index_elementwise")


def gather_sites(flat, settings, tracers, feats, first: int,
                 steps: int) -> dict:
    """{kernel kind: {site: device ms a spp}} of the row-gather kernels
    over `steps` eager samples from sample `first`, each kernel given to
    the innermost site range (GATHER_SITES) or program span whose host
    operator launched it, "(none)" where neither encloses it; and under
    "trace_sites" the trace kernels' device ms a spp by the innermost
    program span that launched them."""
    import functools
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from platinum_tpu_torch.render import integrator
    from portbench import profiling

    trace_names = profiling.trace_patterns()
    saved = []
    for mod_name, attr, site in GATHER_SITES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _site=site, **kw):
            with record_function("site." + _site):
                return _fn(*a, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, functools.wraps(fn)(wrapped))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(steps):
                integrator.render_sample(flat, settings, first + k,
                                         tracers=tracers, features=feats)
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {kind: collections.Counter() for kind in GATHER_KERNELS}
    traced = collections.Counter()
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if not any(x in k.name for x in trace_names):
                continue
            # a kernel launched outside a torch operator (the trace
            # kernels' ctypes launch) is the span's own
            p = e
            while p is not None and not p.name.startswith("integrator."):
                p = p.cpu_parent
            traced[p.name if p is not None else "(none)"] += (
                k.duration * 1e-3 / steps)
        kernels = [k for k in getattr(e, "kernels", ())
                   if any(kind in k.name for kind in GATHER_KERNELS)]
        if not kernels:
            continue
        p, site = e.cpu_parent, "(none)"
        while p is not None:
            if p.name.startswith("site."):
                site = p.name[len("site."):]
                break
            if site == "(none)" and p.name.startswith(
                    ("integrator.", "renderer.")):
                site = p.name      # the innermost span, unless a site
            p = p.cpu_parent
        for k in kernels:
            kind = next(x for x in GATHER_KERNELS if x in k.name)
            out[kind][site] += k.duration * 1e-3 / steps
    out = {kind: dict(c.most_common()) for kind, c in out.items()}
    out["trace_sites"] = dict(traced.most_common())
    return out


def trace_cell(spec: dict, seed: int, seconds: float, tracing: bool,
               device: str = "cuda", turns: int = 0,
               gather_steps: int = 0) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.renderer import Renderer
    from platinum_tpu_torch.render.types import RenderSettings
    from platinum_tpu_torch.utils import telemetry
    from portbench import harness, profiling, scenes

    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    parts = dict(imports_s=time.perf_counter() - T_START)
    if tracing:
        telemetry.start()
    traffic, config = spec["traffic"], spec["config"]
    t = time.perf_counter()
    arrays = scenes.make(config)
    settings = RenderSettings(width=traffic["width"],
                              height=traffic["height"], spp=1 << 30,
                              **config["settings"])
    scene, cam = harness.port_scene(arrays)
    parts["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    r = Renderer(scene, device=device)
    r.start_render(cam, settings)
    sync()
    parts["start_render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    r.render()                                  # warm step: sample 0
    sync()
    parts["warm_step_s"] = time.perf_counter() - t
    t = time.perf_counter()
    first = 1 + seed % harness.FIRST_SAMPLES
    buf = io.BytesIO()
    np.savez(buf, buckets=r.readback().reshape(1, -1, 3), accumulated=first)
    buf.seek(0)
    r.load_checkpoint(buf)
    sync()
    parts["resume_s"] = time.perf_counter() - t
    parts["setup_s"] = time.perf_counter() - T_START
    out = dict(workload=spec["cell"]["name"], seed=seed, tracing=tracing,
               setup=parts)
    if tracing:
        setup = telemetry.drain()
        out["setup_spans"] = telemetry.summary(setup["spans"])
        out["setup_counters"] = setup["counters"]

    def window():
        steps = 0
        w0 = time.perf_counter()
        while True:
            r.render()
            steps += 1
            if time.perf_counter() - w0 >= seconds:
                break
        sync()
        return time.perf_counter() - w0, steps

    if turns:
        out["turns"] = []
        for on in [False, True, True, False] * (turns // 2) + [
                False, True] * (turns % 2):
            (telemetry.start if on else telemetry.stop)()
            window_s, steps = window()
            telemetry.stop()
            telemetry.drain()
            out["turns"].append([on, window_s * 1e3 / steps, steps])
        return out
    window_s, steps = window()
    out.update(window_s=window_s, window_steps=steps,
               ms_per_spp=window_s * 1e3 / steps)
    if not tracing:
        return out
    win = telemetry.drain()
    out["window_spans"] = telemetry.summary(win["spans"])
    out["window_counters"] = win["counters"]

    tracers = integrator.make_tracers(r.flat, r.settings)
    feats = analyze_features(r.flat)
    nxt = first + steps
    telemetry.drain()
    rays, n = 0.0, 0
    sync()
    p0 = time.perf_counter()
    while n < 2 or time.perf_counter() - p0 < PLAIN_SECONDS:
        _, k = integrator.render_sample(r.flat, r.settings, nxt + n,
                                        tracers=tracers, return_stats=True,
                                        features=feats)
        rays += float(k)
        n += 1
    sync()
    plain = telemetry.drain()
    plain.update(plain_spp=n, plain_s=time.perf_counter() - p0, rays=rays)
    out["plain"] = dict(spp=n, seconds=plain["plain_s"], rays=rays,
                        spans=telemetry.summary(plain["spans"]),
                        counters=plain["counters"])
    del tracers

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(profiling.WINDOW):
            for _ in range(PROFILED_STEPS):
                r.render()
            sync()
    profiled = telemetry.drain()
    profiled["spp"] = PROFILED_STEPS
    out["profiled_counters"] = profiled["counters"]
    out["profiled_spans"] = telemetry.summary(profiled["spans"])
    dev, host = profiling.from_profiler(prof)
    summ = profiling.summarize(dev, host, profiling.trace_patterns())
    names = {s["name"] for s in profiled["spans"]}
    win_ev = [(s, e) for n_, s, e in host if n_ == profiling.WINDOW][0]
    out["profile"] = dict(
        launches_per_spp=summ["launches"] / PROFILED_STEPS,
        syncs_per_spp=summ["syncs"] / PROFILED_STEPS,
        idle_pct=100.0 * (1.0 - summ["busy_s"] / summ["window_s"]),
        syncs_by_span=syncs_by_span(host, names, win_ev),
        idle_gaps_by_span=name_gaps(dev, host, names, win_ev),
        idle_gaps_harness=summ["idle_gaps"])
    out["readings"] = readings(setup, plain, profiled)
    if gather_steps:
        tracers = integrator.make_tracers(r.flat, r.settings)
        out["gather_sites"] = gather_sites(
            r.flat, r.settings, tracers, feats,
            nxt + n + PROFILED_STEPS, gather_steps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3037000493)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--turns", type=int, default=0)
    ap.add_argument("--gather-sites", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("torch_trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.find_cell(harness.load_json("BENCHMARK.json"),
                             args.workload)
    out = trace_cell(spec, args.seed, args.seconds, bool(args.tracing),
                     turns=args.turns, gather_steps=args.gather_sites)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out["card"] = smi.stdout.strip()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
