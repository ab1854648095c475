"""The busy-share, launch, sync and kernel-time arithmetic and the
bytes-only trace bound, on a recorded profiler table."""

import pytest

from portbench import profiling, roofline

PATTERNS = profiling.trace_patterns()

# (name, start_us, end_us): a 1,000 us window with two trace kernels, two
# shading kernels that overlap, a copy, and one kernel outside the window
DEVICE = [
    ("void (anonymous namespace)::wide_trace_warp_kernel<false, false, 4>",
     100.0, 300.0),
    ("void at::native::vectorized_elementwise_kernel<4, Mul>", 250.0, 400.0),
    ("void at::native::vectorized_elementwise_kernel<4, Add>", 380.0, 420.0),
    ("Memcpy DtoH (Device -> Pageable)", 600.0, 650.0),
    ("void (anonymous namespace)::wide_trace_warp_kernel<true, false, 4>",
     900.0, 1100.0),
    ("void at::native::reduce_kernel<512>", 2000.0, 2100.0),
]
HOST = [
    (profiling.WINDOW, 0.0, 1000.0),
    ("aten::mul", 10.0, 60.0),
    ("cudaLaunchKernel", 20.0, 25.0),
    ("cudaLaunchKernel", 30.0, 35.0),
    ("aten::item", 450.0, 590.0),
    ("cudaStreamSynchronize", 500.0, 580.0),
    ("cudaMemcpyAsync", 460.0, 470.0),
    ("cudaLaunchKernel", 1500.0, 1505.0),       # after the window
]


def test_busy_idle_launches_and_syncs():
    s = profiling.summarize(DEVICE, HOST, PATTERNS)
    assert s["window_s"] == pytest.approx(1e-3)
    # union: [100, 420] + [600, 650] + [900, 1000] = 470 us
    assert s["busy_s"] == pytest.approx(470e-6)
    assert s["trace_kernel_s"] == pytest.approx(300e-6)   # 200 + 100 clipped
    assert s["other_kernel_s"] == pytest.approx(190e-6)   # the copy is no kernel
    assert s["trace_launches"] == 2
    assert s["launches"] == 2 and s["syncs"] == 1
    gaps = dict((round(t * 1e6), n) for n, t in s["idle_gaps"])
    assert gaps[100] == "python (no operator)" or gaps[100] == "aten::mul"
    assert gaps[180] == "cudaStreamSynchronize"           # 420..600, mid 510
    assert s["device_ops"][0][0].endswith("<false, false, 4>")


def test_metric_readers_on_the_recorded_table():
    from portbench.harness import reader
    import os
    mdir = os.path.join(os.path.dirname(profiling.__file__), "metrics")
    rec = dict(profile=profiling.summarize(DEVICE, HOST, PATTERNS), spp=2,
               rays=4e6, plain_s=0.5, plain_spp=2, triangles=1000,
               kind="NVIDIA H100 80GB HBM3", post_spans=[0.004, 0.006])
    assert reader(mdir, "device.idle_pct")(rec) == pytest.approx(53.0)
    assert reader(mdir, "dispatch.launches_per_spp")(rec) == 1.0
    assert reader(mdir, "integrator.host_syncs_per_spp")(rec) == 0.5
    assert reader(mdir, "integrator.mrays_per_s")(rec) == pytest.approx(8.0)
    assert reader(mdir, "trace.device_ms_per_spp")(rec) == pytest.approx(0.15)
    assert reader(mdir, "shading.device_ms_per_spp")(rec) == pytest.approx(0.095)
    assert reader(mdir, "post.display_ms")(rec) == pytest.approx(5.0)
    need = roofline.trace_bytes(2e6, 1.0, 1000) / 3.35e12
    assert reader(mdir, "trace_roofline")(rec) == pytest.approx(
        100 * need / 150e-6)
    # nothing to read: no value, never a zero share
    assert reader(mdir, "trace_roofline")(dict(rec, kind="cpu")) is None
    assert reader(mdir, "post.display_ms")(dict(rec, post_spans=[])) is None


def test_trace_bound_is_bytes_only():
    # 1e6 rays (half closest, half shadow) and 16 launches over 271,010
    # triangles
    b = roofline.trace_bytes(1e6, 16, 271010)
    assert b == 0.5e6 * (28 + 16) + 0.5e6 * (28 + 1) + 16 * 271010 * 36
    assert roofline.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == 3.35e12
    assert roofline.peak("some other card", "hbm_bytes_per_s") is None
