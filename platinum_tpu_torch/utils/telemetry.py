"""Copy of platinum_tpu/utils/telemetry.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package. It adds the port's spans and counters
(below the event lines).

Structured render telemetry (SURVEY §5 metrics/observability).

The reference logs ad-hoc std::println timings and shows a progress bar
(pt_viewport.cpp:107-124); here every subsystem can emit machine-parseable
JSON event lines. Enabled by PLATINUM_TPU_LOG=1 (stderr) or
PLATINUM_TPU_LOG=<path> (append to file); silent and zero-cost otherwise.

Spans and counters: `span(name, ...)` times a stretch of host work,
`count(name, n)` adds to a host counter and `count_device(name, t)` keeps
a 0-d device tensor that is summed into its counter at `drain()`. They
record only while tracing is on: between `start()` and `stop()`, or for
the whole process when PLATINUM_TPU_LOG is set at import. Otherwise
`span` returns one shared no-op context after one flag test, and the
counters return after the same test: no clock read, no allocation, no
device call. A span records its name, start and end
(`time.perf_counter_ns`), its parent span, the step it belongs to
(given, or its parent's) and its small attrs; while a torch.profiler is
recording it also enters a profiler record of its name, so the span sits
in the profiler's host table on the device trace's clock. That record is
the host-only kind (`_RecordFunctionFast`): `record_function` would also
leave a copy of the span on the device timeline, which a reader of the
trace would count as device work. Records stay in memory until `drain()`
returns and clears them. Inside `capture()` (a CUDA graph capture) spans
record nothing and the counters go to a `Recording`, tracing on or off,
which each replay of the graph adds again.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch
from torch.autograd import profiler as _profiler

_DEST = None
_CHECKED = False


def _dest():
    global _DEST, _CHECKED
    if not _CHECKED:
        _CHECKED = True
        v = os.environ.get("PLATINUM_TPU_LOG", "")
        if v == "1":
            _DEST = sys.stderr
        elif v:
            _DEST = open(v, "a")
    return _DEST


def enabled() -> bool:
    return _dest() is not None


def log_event(event: str, **fields) -> None:
    """Emit one JSON line: {"t": <unix>, "event": ..., **fields}."""
    d = _dest()
    if d is None:
        return
    rec = {"t": round(time.time(), 3), "event": event}
    rec.update({k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in fields.items()})
    print(json.dumps(rec), file=d, flush=True)


# ----------------------------------------------------------------------
# Spans and counters
# ----------------------------------------------------------------------

_ON = bool(os.environ.get("PLATINUM_TPU_LOG", ""))
_SPANS: list = []       # [name, start_ns, end_ns, parent record, step, attrs]
_OPEN: list = []        # the records of the spans entered and not left
_COUNTS: dict = {}
_DEVICE: dict = {}      # name -> [0-d tensors]
_REC = None             # a Recording while a stretch is captured


def tracing() -> bool:
    """Whether spans and counters record now."""
    return _ON and _REC is None


def start() -> None:
    """Turn tracing on (records kept from earlier stay)."""
    global _ON
    _ON = True


def stop() -> None:
    """Turn tracing off; what was recorded waits for `drain()`."""
    global _ON
    _ON = False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, rec):
        self.rec = rec
        self.rf = None

    def __enter__(self):
        rec = self.rec
        if _OPEN:
            parent = _OPEN[-1]
            rec[3] = parent
            if rec[4] is None:
                rec[4] = parent[4]
        _SPANS.append(rec)
        _OPEN.append(rec)
        if _profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(rec[0])
            self.rf.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _OPEN.pop()
        return False


def span(name: str, *, step=None, bounce=None, lanes=None, cap=None,
         preview=None, texels=None):
    """A context that records one span while tracing is on, else the
    shared no-op context. `step` names the step the span belongs to (a
    span without one takes its parent's); `bounce`, `lanes`, `cap`,
    `preview` and `texels` are kept as attrs where given."""
    if not _ON or _REC is not None:
        return _NULL
    attrs = {k: v for k, v in (("bounce", bounce), ("lanes", lanes),
                               ("cap", cap), ("preview", preview),
                               ("texels", texels))
             if v is not None}
    return _Span([name, 0, 0, None, step, attrs])


def counting() -> bool:
    """Whether the counters record now: tracing is on, or a stretch is
    being captured. A caller that must launch work to form a counter's
    mask asks this first."""
    return _ON


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name` while tracing is on."""
    if _ON and n:
        if _REC is not None:
            _REC.counts.append((name, n))
        else:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def count_device(name: str, t) -> None:
    """Keep the 0-d tensor `t` for the counter `name` while tracing is
    on: no synchronise here; `drain()` sums the tensors. A tensor of
    more dimensions (a lane mask) is summed here first, one launch, and
    only then: with tracing off nothing is launched."""
    if not _ON:
        return
    if t.dim():
        t = t.sum()
    if _REC is not None:
        _REC.device.append((name, t))
    else:
        _DEVICE.setdefault(name, []).append(t)


class Recording:
    """What a captured stretch counted: `counts` [(name, n)] and `device`
    [(name, 0-d tensor)], in order. `replay()` adds them as the stretch
    would have, each device tensor copied (its memory is the capture's,
    which the next replay overwrites)."""

    def __init__(self):
        self.counts = []
        self.device = []

    def replay(self) -> None:
        if not tracing():
            return
        for name, n in self.counts:
            count(name, n)
        for name, t in self.device:
            count_device(name, t.clone())


@contextlib.contextmanager
def capture():
    """A context in which spans record nothing and the counters go to the
    Recording it yields, whether tracing is on or off; the counters
    recorded before are untouched. For a CUDA graph capture: the work
    runs later, on each replay, and `Recording.replay()` counts it
    then."""
    global _ON, _REC
    was_on, rec = _ON, Recording()
    _ON, _REC = True, rec
    try:
        yield rec
    finally:
        _ON, _REC = was_on, None


def drain() -> dict:
    """{"spans": [...], "counters": {...}} of everything recorded since
    the last drain, which is cleared. Spans still open stay for the next
    drain. Each span is a dict of name, start_ns, end_ns, parent (its
    index in this list, None for a root or a parent drained before),
    step and its attrs. Device counters are summed here, which waits for
    the device."""
    global _SPANS
    done = [r for r in _SPANS if r[2]]
    _SPANS = [r for r in _SPANS if not r[2]]
    index = {id(r): i for i, r in enumerate(done)}
    spans = [dict(name=r[0], start_ns=r[1], end_ns=r[2],
                  parent=(index.get(id(r[3])) if r[3] is not None else None),
                  step=r[4], **r[5])
             for r in done]
    counters = dict(_COUNTS)
    for name, ts in _DEVICE.items():
        total = 0.0
        for dev in {t.device for t in ts}:
            total += float(torch.stack([t.reshape(()).double() for t in ts
                                        if t.device == dev]).sum())
        counters[name] = counters.get(name, 0) + total
    _COUNTS.clear()
    _DEVICE.clear()
    return dict(spans=spans, counters=counters)


def summary(spans: list) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} of drained spans; a span's
    self time is its duration less the part its child spans cover."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] += s["end_ns"] - s["start_ns"]
    out = {}
    for s, c in zip(spans, child_ns):
        e = out.setdefault(s["name"], dict(count=0, total_ms=0.0,
                                           self_ms=0.0))
        dur = s["end_ns"] - s["start_ns"]
        e["count"] += 1
        e["total_ms"] += dur * 1e-6
        e["self_ms"] += (dur - c) * 1e-6
    return out


def log_spans() -> None:
    """With PLATINUM_TPU_LOG set and tracing on: drain and emit one
    `spans` event (per span name its count, total and self ms, and the
    counters)."""
    if not (_ON and enabled()):
        return
    d = drain()
    log_event("spans", spans={k: {"count": v["count"],
                                  "total_ms": round(v["total_ms"], 3),
                                  "self_ms": round(v["self_ms"], 3)}
                              for k, v in summary(d["spans"]).items()},
              counters=d["counters"])
