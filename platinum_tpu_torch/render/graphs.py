"""CUDA graphs of the final render's bounces.

One bounce of the wavefront loop (render/integrator.py
`make_bounce_body`) launches about 2,700 small kernels from Python, and
at 1080p the card waits on that dispatch. `BounceGraphs` captures a
bounce as one `torch.cuda.CUDAGraph` the first time a step meets its
key and replays the graph on every later step: the same kernels in the
same order, so the same bits as the eager bounce.

A key is the caller's part (features, the tracer pair, the settings)
and the state's skeleton: every tensor's shape and dtype and the plain
values, the bounce index and the sampler's dimension among them. Before
a replay the state's tensors are copied into the graph's own inputs.
The graph's outputs are its own memory, which its next replay
overwrites: the caller uses them before the next step (render_sample
copies what it returns). Compaction, the deferred shadows' resolution,
the live check and the banking into the image stay eager between
graphs.

The first time a key is met its bounce runs eagerly: that is the step's
result, and it builds what a capture must not make (the kernel library,
device tables and constants). The capture then records the bounce
without running it. The graphs of one BounceGraphs share one memory
pool and are captured in the order a step replays them. They read the
scene's and the tracer pair's tensors by address, so whoever replaces
either drops the BounceGraphs (the Renderer does); each graph keeps the
bounce function it captured, and with it the tensors that function
made.

A capture counts nothing itself. What the bounce counts (telemetry
counters, the LAUNCHES of the packet kernel, the BSDF kernel and the
hit fetch) is recorded at capture and added on each replay, beside
`integrator.graph_captures` and `integrator.graph_replays` (one a
bounce each) and a span `integrator.bounce_graph` (attrs `bounce`,
`lanes`) around the replay.

`graphs_engage` says whether a render may take this path: a CUDA
device, a tracer pair that says it is capturable (the packet kernel's)
and no `chunk_shade` (its chunk count is read on the host). Alpha
cutouts are captured too: their loops have a fixed trip count, trace
through the capturable pair and read nothing on the host. Everything
else renders eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from platinum_tpu_torch.models import bsdf
from platinum_tpu_torch.ops import hitdata, packet_trace
from platinum_tpu_torch.utils import telemetry

# the launch counters a bounce adds to, each captured and replayed
_LAUNCH_TABLES = (packet_trace.LAUNCHES, bsdf.LAUNCHES, hitdata.LAUNCHES)


def graphs_engage(device, tracers, settings, features) -> bool:
    """Whether a bounce of this render can run as a captured graph: a
    pure function of what the render is given."""
    return (torch.device(device).type == "cuda"
            and tracers is not None
            and all(getattr(f, "capturable", False) for f in tracers)
            and not settings.chunk_shade)


def _skeleton(x, leaves: list):
    """x's structure with each tensor appended to `leaves` and standing
    as its (shape, dtype); dicts and dataclasses (the sampler streams)
    are walked, other values kept as they are."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return ("dict", tuple((k, _skeleton(v, leaves))
                              for k, v in x.items()))
    if dataclasses.is_dataclass(x):
        return ("data", type(x),
                tuple((f.name, _skeleton(getattr(x, f.name), leaves))
                      for f in dataclasses.fields(x)))
    return ("value", x)


def _build(skel, leaves):
    """The structure `_skeleton` took apart, its tensors drawn in order
    from the iterator `leaves`."""
    kind = skel[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "dict":
        return {k: _build(v, leaves) for k, v in skel[1]}
    if kind == "data":
        return skel[1](**{k: _build(v, leaves) for k, v in skel[2]})
    return skel[1]


def _capture_graph(fn, inputs: list, pool):
    """(graph, fn(inputs)) with fn's work captured into the graph, in
    `pool`, on a side stream: nothing runs until the graph is replayed.
    It is `torch.cuda.graph` without the emptying of the allocator's
    cache, which would make the eager work between the graphs (and every
    eager render after them) go back to cudaMalloc."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin(pool=pool)
        try:
            out = fn(inputs)
        finally:
            graph.capture_end()
    return graph, out


class _Bounce:
    """One captured bounce: its graph, the function it captured, its
    input and output tensors, and what a replay counts."""

    def __init__(self, graph, body, inputs, out_skel, outputs, rec,
                 launches):
        self.graph = graph
        self.body = body
        self.inputs = inputs
        self.out_skel = out_skel
        self.outputs = outputs
        self.rec = rec
        self.launches = launches

    def replay(self, leaves: list):
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)
        self.graph.replay()
        self.rec.replay()
        for table, launches in zip(_LAUNCH_TABLES, self.launches):
            for k, n in launches.items():
                table[k] += n
        telemetry.count("integrator.graph_replays")
        return _build(self.out_skel, iter(self.outputs))


class BounceGraphs:
    """The captured bounces of one renderer, by key, in one memory pool.
    Empty when made; a bounce is captured the first time a step meets
    its key (`bind`)."""

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def bind(self, body, key):
        """body(state) -> state run through the graphs, `key` the
        caller's part of every bounce's key."""
        def step(state):
            leaves = []
            skel = _skeleton(state, leaves)
            entry = self._graphs.get((key, skel))
            if entry is None:
                out = body(state)
                self._graphs[(key, skel)] = self._capture(body, skel, leaves)
                return out
            with telemetry.span("integrator.bounce_graph",
                                bounce=state["bounce"],
                                lanes=state["o"].shape[0]):
                return entry.replay(leaves)

        return step

    def _capture(self, body, skel, leaves: list) -> _Bounce:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = [t.clone() for t in leaves]
        before = [dict(t) for t in _LAUNCH_TABLES]
        try:
            with telemetry.capture() as rec:
                graph, out = _capture_graph(
                    lambda xs: body(_build(skel, iter(xs))), inputs,
                    self._pool)
            launches = [{k: n - b.get(k, 0) for k, n in t.items()
                         if n != b.get(k, 0)}
                        for t, b in zip(_LAUNCH_TABLES, before)]
        finally:
            # the captured launches run on replay, and count there
            for t, b in zip(_LAUNCH_TABLES, before):
                t.update(b)
        outputs = []
        out_skel = _skeleton(out, outputs)
        telemetry.count("integrator.graph_captures")
        return _Bounce(graph, body, inputs, out_skel, outputs, rec, launches)
