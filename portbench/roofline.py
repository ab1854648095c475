"""Peaks of the card and the bytes-only bound of a trace launch.

The bound does not depend on how a tracer walks its tree: a ray's inputs
are read once, its hit record is written once, and each triangle's nine
vertex floats are read once per launch, at the card's memory bandwidth.
No operation count enters it (one that does not depend on the walk is an
open question), so the share it gives is a floor on how far a trace
kernel is from its limit, never a measure of wasted work.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, the data sheet's dense rates at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  fp32_flops=67e12, bf16_flops=989e12),
}

RAY_IN_BYTES = 28      # origin and direction (6 f32) and the far limit (f32)
CLOSEST_OUT_BYTES = 16  # t, triangle id, two barycentrics
ANY_OUT_BYTES = 1       # the occlusion flag
TRIANGLE_BYTES = 36     # v0, v1, v2 as nine f32


def trace_bytes(rays: float, launches: float, triangles: int) -> float:
    """Least bytes the trace launches of one sample move: `rays` traced
    (closest-hit and shadow rays of live lanes, half each, as the
    integrator counts them), `launches` trace launches, each reading every
    triangle once."""
    half = 0.5 * rays
    return (half * (RAY_IN_BYTES + CLOSEST_OUT_BYTES)
            + half * (RAY_IN_BYTES + ANY_OUT_BYTES)
            + launches * triangles * TRIANGLE_BYTES)


def peak(kind: str, key: str) -> float | None:
    """A peak of the card named `kind`; None for a card not in the table."""
    return PEAKS.get(kind, {}).get(key)
