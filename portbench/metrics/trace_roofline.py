"""trace_roofline: the least time the trace launches of a sample need
(roofline.trace_bytes at the card's memory bandwidth) over their device
time, in percent. Rays per sample come from the plain stretch, launches
and device time per sample from the profiled window."""

from portbench import roofline


def read(rec):
    p = rec.get("profile")
    bw = roofline.peak(rec.get("kind", ""), "hbm_bytes_per_s")
    if (not p or not bw or not rec.get("spp") or not rec.get("rays")
            or not rec.get("plain_spp") or p["trace_kernel_s"] <= 0):
        return None
    spp = rec["spp"]
    need = roofline.trace_bytes(rec["rays"] / rec["plain_spp"],
                                p["trace_launches"] / spp,
                                rec["triangles"]) / bw
    return 100.0 * need / (p["trace_kernel_s"] / spp)
