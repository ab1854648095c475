"""trace.device_ms_per_spp: device time of the trace kernels (names in
trace_kernels.txt) in the profiled window, per sample."""


def read(rec):
    p = rec.get("profile")
    if not p or not rec.get("spp") or p["trace_kernel_s"] <= 0:
        return None
    return p["trace_kernel_s"] * 1e3 / rec["spp"]
