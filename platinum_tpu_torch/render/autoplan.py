"""Measured wavefront-compaction schedules (settings.compact_plan="auto").

Port of platinum_tpu/render/autoplan.py. The static plan of
`integrator._compaction_plan` halves the wave every two bounces; real
scenes lose lanes faster (the JAX package measured the colonnade at 0.23
live after bounce 2). "auto" probes the scene's own decay: a strided
subset of about PROBE_LANES pixels runs the bounce loop once without
compaction, the live fraction after each bounce is read back, and the
schedule becomes `headroom x live` caps in multiples of 512 lanes, a new
segment opening only where the cap shrinks enough. Capping below the live
count stays unbiased (`_compact_state` reweights the survivors).

The probe runs the render path itself, so "auto" is resolved by the
host-level entry points (`Renderer.start_render`, `integrator.render`)
through `resolve_auto_plan`; `_compaction_plan` refuses an unresolved
"auto".
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from platinum_tpu_torch.render.types import RenderSettings

PROBE_LANES = 16384   # strided pixel subset for the live fractions
MIN_COMPACT_N = 8192  # below this the static plan does not compact either


def measure_live_fractions(flat, settings: RenderSettings,
                           probe_spp: int = 1, *,
                           tracers=None) -> np.ndarray:
    """(max_bounces,) mean fraction of lanes still active after each
    bounce, over `probe_spp` samples of a strided pixel subset run through
    the bounce body without compaction, with the scene's own feature set;
    `tracers` is the (trace_closest, trace_any) pair to use (built for
    the probe when None)."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import analyze_features

    probe = replace(settings, compact=False, compact_plan=None,
                    fuse_shadow=False, spp_batch=1)
    feats = analyze_features(flat)
    npx = settings.num_pixels
    stride = max(1, npx // PROBE_LANES)
    ids = torch.arange(0, npx, stride, device=flat.camera.position.device)
    body = integrator.make_bounce_body(flat, probe, feats, tracers)

    fr = np.zeros(settings.max_bounces, np.float64)
    for si in range(probe_spp):
        state = integrator.init_path_state(flat, probe, si, ids)
        for b in range(settings.max_bounces):
            state = body(state)
            fr[b] += float(state["active"].to(torch.float32).mean())
    return fr / probe_spp


def plan_from_live(live, n: int, max_bounces: int, headroom: float = 1.5,
                   floor: int = 2048, shrink: float = 0.67):
    """Compaction plan ((cap, bounce_limit), ...) from per-bounce live
    fractions: live[k] is the fraction active after bounce k+1. The cap
    entering bounce b >= 2 is headroom x live[b-2] x n, rounded up to a
    multiple of 512, clamped to [floor, n] and kept nonincreasing; a
    segment opens only when the cap falls below shrink x the current one."""
    assert len(live) >= max_bounces - 1, (len(live), max_bounces)
    floor = max(512, int(floor))
    caps = []
    cap_min = n
    for b in range(2, max_bounces + 1):
        want = float(headroom) * float(live[b - 2]) * n
        c = int(-(-max(want, float(floor)) // 512) * 512)
        cap_min = min(cap_min, min(c, n))
        caps.append(cap_min)

    plan = []
    cur = n
    for i, c in enumerate(caps):
        b = i + 2
        if c <= shrink * cur:
            plan.append((cur, b - 1))
            cur = c
    plan.append((cur, max_bounces))
    return tuple(plan)


def validate_plan(plan, n: int, max_bounces: int) -> None:
    """Raise unless the caps are in (0, n] and nonincreasing and the
    bounce limits strictly increase and end at max_bounces."""
    if not plan:
        raise ValueError("compact_plan must be a non-empty tuple")
    prev_cap, prev_b = None, 0
    for seg in plan:
        if len(seg) != 2:
            raise ValueError(f"compact_plan segment {seg!r} is not "
                             "(cap, bounce_limit)")
        cap, b = int(seg[0]), int(seg[1])
        if cap <= 0 or cap > n:
            raise ValueError(f"compact_plan cap {cap} out of (0, {n}]")
        if prev_cap is not None and cap > prev_cap:
            raise ValueError("compact_plan caps must be nonincreasing: "
                             f"{plan}")
        if b <= prev_b:
            raise ValueError("compact_plan bounce limits must be strictly "
                             f"increasing: {plan}")
        prev_cap, prev_b = cap, b
    if prev_b != max_bounces:
        raise ValueError(f"compact_plan must end at max_bounces="
                         f"{max_bounces}: {plan}")


def resolve_auto_plan(flat, settings: RenderSettings,
                      probe_spp: int = 1, *, tracers=None) -> RenderSettings:
    """settings with compact_plan="auto" replaced by a measured plan (or
    by None where the static rules would not compact); other settings are
    returned as they are. `tracers` as in measure_live_fractions."""
    if settings.compact_plan != "auto":
        return settings
    n_lanes = settings.num_pixels * max(1, settings.spp_batch)
    if (not settings.compact or n_lanes < MIN_COMPACT_N
            or settings.max_bounces <= 3):
        return replace(settings, compact_plan=None)
    live = measure_live_fractions(flat, settings, probe_spp=probe_spp,
                                  tracers=tracers)
    plan = plan_from_live(live, n_lanes, settings.max_bounces)
    return replace(settings, compact_plan=plan)
