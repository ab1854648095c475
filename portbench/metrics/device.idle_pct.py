"""device.idle_pct: the share of the profiled window in which no
operation ran on the device (1 - the union of device intervals)."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
