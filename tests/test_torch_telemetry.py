"""The port's spans and counters (platinum_tpu_torch/utils/telemetry.py),
on the CPU:

- with tracing off, `span` is the shared no-op context and nothing is
  recorded, allocated, timed or touched;
- spans nest, carry their parent and step, and self times add up to the
  root's total; counters add, device counters are summed at drain;
- a Renderer run on Cornell gives the documented spans per bounce, and
  `renderer.readback` / `renderer.post` / `renderer.combine` on the way
  out; with PLATINUM_TPU_LOG set, `render_done` is followed by one
  `spans` event;
- `integrator.live_lanes` is `rays / 2` of `return_stats` on an mis
  render, and `sync.live_check` counts the bounce loop's tests;
- the `sync.*` counters add up to every call of the render path that
  reads the device on the host or makes a device tensor from a host
  value (counted here by wrapping those torch entry points);
- under a CPU torch.profiler the spans sit in portbench's host table, and
  an idle gap is named by its covering span;
- tools/torch_trace_cell.py's readings of recorded drains, the BSDF
  kernel's share of the lanes among them;
- `telemetry.capture()` records counters for each replay; a bounce
  neither copies from the host nor reads the device (the syncs of a
  sample on the colonnade are its index and the live checks); the rule
  that engages CUDA graphs; the graph path's plumbing against the eager
  path, with a deferred stand-in for the capture.
"""

import collections
import dataclasses
import io
import json
import os
import sys
import tracemalloc

import pytest
import torch

from platinum_tpu_torch.app import scenes
from platinum_tpu_torch.render import integrator
from platinum_tpu_torch.render.flatten import analyze_features, flatten_scene
from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
from platinum_tpu_torch.render.types import FLAG_GMON, RenderSettings
from platinum_tpu_torch.utils import telemetry
from portbench import profiling

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import torch_trace_cell as tc  # noqa: E402

torch.set_num_threads(1)

BOUNCE_CHILDREN = ["integrator.trace_closest", "integrator.shade",
                   "integrator.trace_shadow"]


@pytest.fixture
def tracing():
    telemetry.drain()
    telemetry.start()
    yield
    telemetry.stop()
    telemetry.drain()


def _settings(**kw):
    base = dict(width=8, height=8, spp=2, max_bounces=3, kernel="mis")
    base.update(kw)
    return RenderSettings(**base)


def test_off_is_one_shared_noop_and_records_nothing(monkeypatch):
    assert not telemetry._ON
    telemetry.drain()

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(telemetry.time, "perf_counter_ns", no_clock)

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"{name} read with tracing off")

    dev = Untouchable()
    assert telemetry.span("a") is telemetry.span("b", bounce=1, lanes=2,
                                                 cap=3, step=4)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(256):        # small ints: no new int objects
            with telemetry.span("integrator.bounce", bounce=i, lanes=64):
                telemetry.count("sync.live_check")
                telemetry.count_device("integrator.live_lanes", dev)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = (os.path.abspath(__file__), os.path.abspath(telemetry.__file__))
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename in here and d.count_diff > 0]
    assert grown == []
    assert telemetry.drain() == dict(spans=[], counters={})


def test_spans_nest_with_parent_step_and_self_time(tracing):
    with telemetry.span("root", step=5):
        with telemetry.span("a", bounce=1, lanes=64):
            with telemetry.span("a.inner", cap=512):
                pass
        with telemetry.span("b", preview=True):
            telemetry.count("n")
            telemetry.count("n", 2)
            telemetry.count_device("d", torch.tensor(1.5))
            telemetry.count_device("d", torch.tensor(2.0))
    with telemetry.span("open"):
        first = telemetry.drain()
        with telemetry.span("late"):
            pass
    second = telemetry.drain()

    spans = first["spans"]
    assert [s["name"] for s in spans] == ["root", "a", "a.inner", "b"]
    assert [s["parent"] for s in spans] == [None, 0, 1, 0]
    assert [s["step"] for s in spans] == [5, 5, 5, 5]
    assert spans[1]["bounce"] == 1 and spans[1]["lanes"] == 64
    assert spans[2]["cap"] == 512 and spans[3]["preview"] is True
    assert "bounce" not in spans[0]
    assert all(s["start_ns"] <= s["end_ns"] for s in spans)
    assert first["counters"] == {"n": 3, "d": 3.5}

    summ = telemetry.summary(spans)
    total = spans[0]["end_ns"] - spans[0]["start_ns"]
    assert sum(v["self_ms"] for v in summ.values()) == pytest.approx(
        total * 1e-6, abs=1e-9)
    assert summ["a"]["self_ms"] == pytest.approx(
        summ["a"]["total_ms"] - summ["a.inner"]["total_ms"], abs=1e-9)
    assert all(v["count"] == 1 for v in summ.values())
    # the span open at the first drain comes with the second, its child
    # there pointing at it
    assert [s["name"] for s in second["spans"]] == ["open", "late"]
    assert second["spans"][1]["parent"] == 0
    assert telemetry.drain() == dict(spans=[], counters={})


def test_renderer_spans_per_bounce(tracing):
    scene, cam = scenes.make_cornell_scene()
    r = Renderer(scene, device="cpu")
    r.start_render(cam, _settings())
    setup = telemetry.drain()["spans"]
    assert [s["name"] for s in setup] == [
        "renderer.start_render", "renderer.flatten", "renderer.tracers"]
    assert [s["parent"] for s in setup] == [None, 0, 0]

    r.render()
    d = telemetry.drain()
    spans = d["spans"]
    names = [s["name"] for s in spans]
    assert names[:2] == ["renderer.step", "integrator.sample"]
    assert all(s["step"] == 0 for s in spans)
    bounces = [i for i, n in enumerate(names) if n == "integrator.bounce"]
    assert [spans[i]["bounce"] for i in bounces] == list(range(len(bounces)))
    assert all(spans[i]["lanes"] == 64 for i in bounces)
    for i in bounces:
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids == BOUNCE_CHILDREN
        assert spans[i]["parent"] == 1
    checks = [s for s in spans if s["name"] == "integrator.live_check"]
    assert all(s["parent"] == 1 for s in checks)
    assert d["counters"]["sync.live_check"] == len(checks)
    assert d["counters"]["integrator.wave_lanes"] == 64 * len(bounces)

    r.readback()
    r.output_image()
    out = [s["name"] for s in telemetry.drain()["spans"]]
    assert out == ["renderer.readback", "renderer.post"]


def test_gmon_combine_and_preview_steps(tracing):
    scene, cam = scenes.make_cornell_scene()
    r = Renderer(scene, device="cpu")
    r.start_render(cam, _settings(spp=4, flags=1 | FLAG_GMON,
                                  gmon_buckets=2),
                   preview_scale=2, preview_spp=1)
    telemetry.drain()
    r.render()
    r.render()
    r.readback()
    steps = [s for s in telemetry.drain()["spans"]
             if s["name"] == "renderer.step"]
    assert [(s["step"], s.get("preview")) for s in steps] == [(0, True),
                                                              (0, None)]
    r.render()
    r.readback()
    names = [s["name"] for s in telemetry.drain()["spans"]]
    assert names[-2:] == ["renderer.readback", "renderer.combine"]


def test_log_emits_spans_after_render_done(monkeypatch, tracing):
    buf = io.StringIO()
    monkeypatch.setattr(telemetry, "_CHECKED", True)
    monkeypatch.setattr(telemetry, "_DEST", buf)
    scene, cam = scenes.make_cornell_scene()
    r = Renderer(scene, device="cpu")
    r.start_render(cam, _settings())
    while not r.status & RenderStatus.DONE:
        r.render()
    events = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [e["event"] for e in events][-2:] == ["render_done", "spans"]
    spans = events[-1]["spans"]
    assert spans["renderer.step"]["count"] == 2
    assert spans["renderer.start_render"]["count"] == 1
    assert set(spans["integrator.bounce"]) == {"count", "total_ms",
                                               "self_ms"}
    assert events[-1]["counters"]["sync.live_check"] >= 2
    assert telemetry.drain() == dict(spans=[], counters={})


def _flat(settings):
    scene, cam = scenes.make_cornell_scene()
    flat = flatten_scene(scene, cam, settings, device="cpu")
    return flat, analyze_features(flat)


def test_live_lanes_are_half_the_mis_rays(tracing):
    s = _settings(width=16, height=16, max_bounces=6)
    flat, feats = _flat(s)
    telemetry.drain()
    _, rays = integrator.render_sample(flat, s, 3, return_stats=True,
                                       features=feats)
    c = telemetry.drain()["counters"]
    assert c["integrator.live_lanes"] == float(rays) / 2
    assert 0 < c["integrator.live_lanes"] <= c["integrator.wave_lanes"]


def test_live_check_counts_the_loop_tests(tracing):
    s = _settings(width=16, height=16, max_bounces=64)
    flat, feats = _flat(s)
    telemetry.drain()
    integrator.render_sample(flat, s, 0, features=feats)
    d = telemetry.drain()
    bounces = sum(1 for x in d["spans"] if x["name"] == "integrator.bounce")
    # every lane dies before 64 bounces: each bounce was preceded by a
    # test, and one more test found no lane
    assert bounces < 64
    assert d["counters"]["sync.live_check"] == bounces + 1


BLOCKING_METHODS = ("__bool__", "__int__", "__float__", "__index__", "item",
                    "tolist", "cpu", "nonzero", "numpy")


def _count_blocking(monkeypatch):
    """Wrap the torch entry points that wait for the device on a GPU: a
    host read of a tensor, and a tensor made from host data for a
    device."""
    seen = collections.Counter()
    on = [False]

    def method(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            if on[0]:
                seen[name] += 1
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    for name in BLOCKING_METHODS:
        method(name)
    for name in ("tensor", "as_tensor"):
        orig = getattr(torch, name)

        def make(data, *a, _orig=orig, _name=name, **k):
            if on[0] and k.get("device") is not None and not torch.is_tensor(
                    data):
                seen[_name] += 1
            return _orig(data, *a, **k)
        monkeypatch.setattr(torch, name, make)
    return seen, on


@pytest.mark.parametrize("kw", [
    dict(kernel="mis", max_bounces=3),
    dict(kernel="mis", max_bounces=3, flags=1 | FLAG_GMON, gmon_buckets=2,
         spp=4),
    dict(kernel="mis", max_bounces=8, compact=True, width=96, height=96,
         compact_plan=((9216, 2), (4608, 8))),
], ids=["mis", "gmon", "compact"])
def test_sync_counters_cover_every_blocking_call(monkeypatch, tracing, kw):
    scene, cam = scenes.make_cornell_scene()
    r = Renderer(scene, device="cpu")
    r.start_render(cam, _settings(**kw))
    r.render()
    telemetry.drain()
    seen, on = _count_blocking(monkeypatch)
    on[0] = True
    r.render()
    r.readback()
    r.output_image()
    on[0] = False
    c = telemetry.drain()["counters"]
    syncs = {k: v for k, v in c.items() if k.startswith("sync.") and v}
    # the output path's .cpu() then .numpy() is one copy: numpy() of a
    # host tensor reads nothing of the device
    assert sum(syncs.values()) == sum(seen.values()) - seen["numpy"], (
        syncs, dict(seen))
    assert {"sync.live_check", "sync.readback", "sync.post"} <= set(syncs)


def test_spans_sit_in_the_profilers_host_table(tracing):
    from torch.profiler import ProfilerActivity, profile, record_function

    scene, cam = scenes.make_cornell_scene()
    r = Renderer(scene, device="cpu")
    r.start_render(cam, _settings())
    telemetry.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(profiling.WINDOW):
            r.render()
    device, host = profiling.from_profiler(prof)
    names = {n for n, _, _ in host}
    assert {"renderer.step", "integrator.sample", "integrator.bounce",
            *BOUNCE_CHILDREN} <= names
    recorded = telemetry.drain()["spans"]
    ev = {n: (s, e) for n, s, e in host if n == "renderer.step"}
    s0, s1 = ev["renderer.step"]
    # the profiler's interval of a span holds that of its first child
    kids = [(s, e) for n, s, e in host if n == "integrator.sample"]
    assert kids and s0 <= kids[0][0] <= kids[0][1] <= s1
    assert len([x for x in recorded if x["name"] == "renderer.step"]) == 1
    assert not [n for n, _, _ in device if n in names]


GAP_TABLE = dict(
    device=[("k1", 0.0, 10.0), ("k2", 60.0, 70.0), ("k3", 90.0, 100.0)],
    host=[(profiling.WINDOW, 0.0, 100.0),
          ("integrator.bounce", 5.0, 95.0),
          ("integrator.shade", 8.0, 65.0),
          ("aten::select", 30.0, 40.0),
          ("integrator.trace_shadow", 66.0, 94.0)])


def test_summarize_names_a_gap_by_its_covering_span():
    s = profiling.summarize(GAP_TABLE["device"], GAP_TABLE["host"], ("k",))
    assert s["idle_gaps"][0][0] == "aten::select"
    assert s["idle_gaps"][1][0] == "integrator.trace_shadow"
    names = {"integrator.bounce", "integrator.shade",
             "integrator.trace_shadow"}
    gaps = tc.name_gaps(GAP_TABLE["device"], GAP_TABLE["host"], names,
                        (0.0, 100.0))
    assert [g[0] for g in gaps] == ["integrator.shade / aten::select",
                                    "integrator.trace_shadow"]
    assert [round(g[1] * 1e6) for g in gaps] == [50, 20]


def test_syncs_are_put_down_to_their_span():
    host = GAP_TABLE["host"] + [("cudaStreamSynchronize", 31.0, 32.0),
                                ("cudaMemcpy", 70.0, 71.0),
                                ("cudaStreamSynchronize", 96.0, 97.0),
                                ("cudaStreamSynchronize", 101.0, 102.0)]
    names = {"integrator.bounce", "integrator.shade",
             "integrator.trace_shadow"}
    assert tc.syncs_by_span(host, names, (0.0, 100.0)) == {
        "integrator.shade": 1, "integrator.trace_shadow": 1,
        "(no span)": 1}


def _drain(name, ms, parent=None):
    return dict(name=name, start_ns=0, end_ns=int(ms * 1e6), parent=parent,
                step=None)


def test_readings_of_recorded_drains():
    setup = dict(spans=[_drain("renderer.start_render", 9000),
                        _drain("renderer.flatten", 4000, 0),
                        _drain("renderer.tracers", 250, 0),
                        _drain("renderer.autoplan", 1500, 0)], counters={})
    plain = dict(plain_spp=4, spans=[
        _drain("integrator.shade", 100), _drain("integrator.shade", 60),
        _drain("integrator.trace_closest", 30),
        _drain("integrator.trace_shadow", 10)],
        counters={"integrator.wave_lanes": 1000,
                  "integrator.live_lanes": 250.0})
    profiled = dict(spp=2, spans=[], counters={
        "sync.live_check": 16, "sync.wave_bounds": 48, "sync.post": 0,
        "integrator.wave_lanes": 10})
    got = tc.readings(setup, plain, profiled)
    assert got == pytest.approx({
        "setup.flatten_s": 4.0, "setup.tracer_build_s": 0.25,
        "setup.autoplan_s": 1.5, "integrator.sync_sites_per_spp": 32.0,
        "integrator.live_lane_pct": 25.0,
        "dispatch.shade_host_ms_per_spp": 40.0,
        "dispatch.trace_host_ms_per_spp": 10.0})
    # a static plan has no probe: no autoplan reading, and no lanes
    # counted reads no live share
    setup["spans"].pop()
    plain["counters"] = {}
    got = tc.readings(setup, plain, profiled)
    assert "setup.autoplan_s" not in got
    assert "integrator.live_lane_pct" not in got


def test_bsdf_kernel_pct_reads_kernel_lanes_over_bsdf_lanes():
    setup = dict(spans=[], counters={})
    plain = dict(plain_spp=1, spans=[], counters={})
    profiled = dict(spp=2, spans=[], counters={
        "bsdf.lanes": 8000, "bsdf.kernel_lanes": 6000})
    got = tc.readings(setup, plain, profiled)
    assert got["integrator.bsdf_kernel_pct"] == pytest.approx(75.0)
    # the CPU runs the plain code: no lane shaded by the kernel
    del profiled["counters"]["bsdf.kernel_lanes"]
    assert tc.readings(setup, plain, profiled)[
        "integrator.bsdf_kernel_pct"] == 0.0
    # no BSDF call recorded, no reading
    profiled["counters"] = {}
    assert "integrator.bsdf_kernel_pct" not in tc.readings(setup, plain,
                                                           profiled)


def test_capture_records_counters_for_each_replay(tracing):
    telemetry.count("before", 2)
    with telemetry.capture() as rec:
        assert telemetry.span("integrator.bounce") is telemetry._NULL
        assert not telemetry.tracing()
        telemetry.count("integrator.wave_lanes", 64)
        telemetry.count_device("integrator.live_lanes", torch.tensor(5.0))
    assert telemetry.tracing()
    assert telemetry.drain() == dict(spans=[], counters={"before": 2})
    rec.replay()
    rec.replay()
    assert telemetry.drain()["counters"] == {
        "integrator.wave_lanes": 128, "integrator.live_lanes": 10.0}
    # recorded with tracing off, counted only where a replay traces
    telemetry.stop()
    with telemetry.capture() as rec:
        telemetry.count("integrator.wave_lanes", 64)
    assert not telemetry._ON
    rec.replay()
    telemetry.start()
    rec.replay()
    assert telemetry.drain()["counters"] == {"integrator.wave_lanes": 64}


def _small_colonnade(**kw):
    s = RenderSettings(**dict(dict(width=16, height=16, spp=1, max_bounces=3,
                                   kernel="mis", tracer="packet",
                                   instancing="off"), **kw))
    scene, cam = scenes.make_colonnade_scene(sphere_res=(12, 16))
    flat = flatten_scene(scene, cam, s, device="cpu")
    return flat, s, analyze_features(flat)


def test_a_sample_syncs_only_to_test_for_live_lanes(monkeypatch, tracing):
    """No bounce copies a constant from the host (the wave bounds, the
    frame, GGX and BSDF vectors) or reads the device: a sample's only
    syncs are the sampler's index and the live checks between bounces."""
    flat, s, feats = _small_colonnade()
    tracers = integrator.make_tracers(flat, s)
    assert all(f.capturable for f in tracers)
    telemetry.drain()
    seen, on = _count_blocking(monkeypatch)
    on[0] = True
    integrator.render_sample(flat, s, 5, tracers=tracers, features=feats)
    on[0] = False
    c = telemetry.drain()["counters"]
    syncs = {k: v for k, v in c.items() if k.startswith("sync.") and v}
    assert set(syncs) == {"sync.live_check", "sync.sample_index"}
    assert syncs["sync.sample_index"] == 1
    assert sum(syncs.values()) == sum(seen.values())


def test_graphs_engage_only_where_a_capture_is_sound():
    flat, s, feats = _small_colonnade()
    packet = integrator.make_tracers(flat, s)
    cuda = torch.device("cuda")
    engage = integrator.graphs_engage
    assert engage(cuda, packet, s, feats)
    assert not engage("cpu", packet, s, feats)
    assert not engage(cuda, None, s, feats)
    assert not engage(cuda, packet, dataclasses.replace(s, chunk_shade=64),
                      feats)
    assert engage(cuda, packet, s, feats | {"alpha"})
    for tracer in ("bf", "bvh"):
        t = dataclasses.replace(s, tracer=tracer)
        assert not engage(cuda, integrator.make_tracers(flat, t), t, feats)
    brute = integrator.make_tracers(flat, dataclasses.replace(s,
                                                              tracer="brute"))
    assert not engage(cuda, brute, s, feats)
    # the kernel's pair alone: held to its plain version, no capture
    from platinum_tpu_torch.ops import packet_trace as pt
    plain = pt.make_packet_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                                  flat.wbvh_meta, flat.wbvh_slot,
                                  trace_fn=pt.trace_wide_reference)
    assert not engage(cuda, plain, s, feats)


class _DeferredGraph:
    """A stand-in for a CUDA graph on the CPU: the capture runs the
    function once, for its outputs; a replay runs it again on the same
    inputs, counting nothing, and copies the results into those outputs
    and into the device counters the capture recorded."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.rec = telemetry._REC
        self.out = fn(inputs)
        self.replays = 0

    def replay(self):
        from platinum_tpu_torch.render import graphs

        with telemetry.capture() as rec:
            new = self.fn(self.inputs)
        mine, fresh = [], []
        graphs._skeleton(self.out, mine)
        graphs._skeleton(new, fresh)
        mine += [t for _, t in self.rec.device]
        fresh += [t for _, t in rec.device]
        for dst, src in zip(mine, fresh):
            dst.copy_(src)
        self.replays += 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(compact=True, compact_plan=((9216, 2), (4608, 4)), width=96,
         height=96),
    dict(fuse_shadow=True),
], ids=["plain", "compact", "fuse_shadow"])
def test_replayed_bounces_are_the_eager_bounces(monkeypatch, tracing, kw):
    """The graph path's plumbing on the CPU, a deferred stand-in for the
    capture: the same radiance, rays and counters as the eager path over
    consecutive samples, one capture per bounce key, and a returned
    tensor that the next sample leaves alone."""
    from platinum_tpu_torch.render import graphs

    made = []

    def capture(fn, inputs, pool):
        made.append(_DeferredGraph(fn, inputs))
        return made[-1], made[-1].out

    monkeypatch.setattr(graphs, "_capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(integrator, "graphs_engage", lambda *a: True)
    s = _settings(**dict(dict(width=16, height=16, max_bounces=4), **kw))
    flat, feats = _flat(s)
    tracers = integrator.make_tracers(flat, s)
    g = graphs.BounceGraphs()
    telemetry.drain()
    counters = []
    for path in ("eager", "graphs"):
        runs = []
        for i in range(3):
            runs.append(integrator.render_sample(
                flat, s, 7 + i, tracers=tracers, return_stats=True,
                features=feats, graphs=g if path == "graphs" else None))
        counters.append(telemetry.drain()["counters"])
        if path == "eager":
            eager = [(a.clone(), b.clone()) for a, b in runs]
            continue
        for (a, b), (ea, eb) in zip(runs, eager):
            assert torch.equal(a, ea) and torch.equal(b, eb)
    assert 0 < len(g) == counters[1]["integrator.graph_captures"] == len(
        made)
    assert counters[1]["integrator.graph_replays"] == sum(
        x.replays for x in made) > 0
    for k in ("integrator.wave_lanes", "integrator.live_lanes",
              "sync.live_check"):
        assert counters[1][k] == counters[0][k]


def test_graph_bounce_share_of_recorded_drains():
    setup = dict(spans=[], counters={})
    plain = dict(plain_spp=1, spans=[], counters={})
    profiled = dict(spp=2, spans=[_drain("integrator.bounce", 1)] * 2
                    + [_drain("integrator.bounce_graph", 1)] * 14,
                    counters={"integrator.graph_replays": 14})
    got = tc.readings(setup, plain, profiled)
    assert got["integrator.graph_bounce_pct"] == pytest.approx(87.5)
    profiled["spans"] = profiled["spans"][2:]
    assert tc.readings(setup, plain, profiled)[
        "integrator.graph_bounce_pct"] == 100.0
    profiled.update(spans=[], counters={})
    assert "integrator.graph_bounce_pct" not in tc.readings(setup, plain,
                                                            profiled)
