"""integrator.host_syncs_per_spp: runtime calls that wait for the device
(synchronises, blocking copies) inside the profiled window, per sample:
the integrator's per-bounce `active.any()` and compaction reads, the
display copy."""


def read(rec):
    p = rec.get("profile")
    if not p or not rec.get("spp"):
        return None
    return p["syncs"] / rec["spp"]
