"""dispatch.launches_per_spp: kernel-launch runtime calls of the host
inside the profiled window, per sample rendered there."""


def read(rec):
    p = rec.get("profile")
    if not p or not rec.get("spp") or not p["launches"]:
        return None
    return p["launches"] / rec["spp"]
