"""Copy of platinum_tpu/utils/telemetry.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Structured render telemetry (SURVEY §5 metrics/observability).

The reference logs ad-hoc std::println timings and shows a progress bar
(pt_viewport.cpp:107-124); here every subsystem can emit machine-parseable
JSON event lines. Enabled by PLATINUM_TPU_LOG=1 (stderr) or
PLATINUM_TPU_LOG=<path> (append to file); silent and zero-cost otherwise.
"""

from __future__ import annotations

import json
import os
import sys
import time

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
