"""integrator.mrays_per_s: closest-hit and shadow rays of live lanes
(`render_sample(..., return_stats=True)`) over the host-clock time of a
plain stretch of samples outside the profiler."""


def read(rec):
    if not rec.get("plain_s") or not rec.get("rays"):
        return None
    return rec["rays"] / rec["plain_s"] / 1e6
