"""The metric arithmetic: rates over the whole window, the p95 over every
image, the trace's busy and idle time, and the readers' shares from a
synthetic trace."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, readers, trace  # noqa: E402
from benchmark.reference import counts as C  # noqa: E402


def test_rate_is_all_samples_over_the_whole_window():
    w = dict(samples=3 * 512 * 512 * 256, window_s=2.5, latencies_s=[])
    assert harness.end_to_end("msamples_per_s", w, 1.0, 0) == \
        pytest.approx(3 * 512 * 512 * 256 / 2.5 / 1e6)


def test_p95_is_over_every_image():
    lat = [0.05] * 95 + [0.5] * 5
    got = harness.end_to_end("image_p95_ms", dict(latencies_s=lat), 0, 0)
    assert got == pytest.approx(0.05 * 1e3 + 0.05 * (0.5 - 0.05) * 1e3)
    assert harness.end_to_end("image_p95_ms", dict(latencies_s=[]), 0, 0) \
        is None


def test_step_ms_and_memory():
    w = dict(window_s=3.0, steps=60)
    assert harness.end_to_end("step_ms", w, 0, 0) == pytest.approx(50.0)
    assert harness.end_to_end("peak_mem_gib", w, 0, 3 << 29) == 1.5
    assert harness.end_to_end("setup_s", w, 12.5, 0) == 12.5
    with pytest.raises(harness.RunError):
        harness.end_to_end("tokens_per_s", w, 0, 0)


def _event(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


def synthetic():
    """A 1,000 us window: K1 for 300 us, a sort for 100 us, a copy for 50
    us, one kernel past the window's end clipped to it; the host in
    ``bench.render`` and then synchronizing."""
    return [
        _event(trace.WINDOW, "user_annotation", 1000, 1000),
        _event("bench.render", "user_annotation", 1000, 600),
        _event("cudaStreamSynchronize", "cuda_runtime", 1700, 250),
        _event("void megakernel_fwd_kernel<true>(K1Params)", "kernel",
               1100, 300),
        _event("_Z12isect_kernelILb1EEv11IsectParams", "kernel", 1400, 50),
        _event("void at::native::radixSortKVInPlace<...>", "kernel",
               1450, 100),
        _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1800, 50),
        _event("void at::elementwise_kernel<...>", "kernel", 1980, 100),
        _event("aten::add", "cpu_op", 1010, 5),
    ]


def test_trace_busy_idle_and_labels():
    tr = trace.Trace(synthetic())
    assert tr.window_s == pytest.approx(1000e-6)
    # 300 + 50 + 100 + 50 + 20 (clipped) us busy.
    assert tr.busy_s == pytest.approx(520e-6)
    assert tr.by_label["k1"] == pytest.approx(300e-6)
    assert tr.by_label["k6"] == pytest.approx(50e-6)
    assert "k2" not in tr.by_label
    assert tr.device_s == pytest.approx(520e-6)
    gaps = dict(tr.gaps)
    # Each gap is named by the host event at its middle: 1000-1100 by
    # bench.render, 1550-1800 by none (bench.render ends at 1600, the
    # synchronize starts at 1700), 1850-1980 by the synchronize.
    assert gaps["bench.render"] == pytest.approx(100e-6)
    assert gaps["(no host event)"] == pytest.approx(250e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(130e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void megakernel_fwd_kernel")
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_kernel_labels_by_whole_name():
    assert trace.kernel_label("void isect_kernel<true>(IsectParams)") == "k6"
    assert trace.kernel_label("isect_mxu_kernel(IsectParams)") == "k6m"
    assert trace.kernel_label("void bounce_bwd_kernel(BounceBwdParams)") \
        == "k10"
    assert trace.kernel_label("_Z13bounce_kernelILb0ELb1EEv12BounceParams") \
        == "k11"
    assert trace.kernel_label("void shade_kernel<false, true>(X)") == "k7"
    assert trace.kernel_label("void at::native::vectorized_elementwise_"
                              "kernel<4>") is None


def test_readers_on_synthetic_trace():
    tr = trace.Trace(synthetic())
    ctx = dict(trace=tr, counts=[[1000, 800, 600, 300], [800, 500, 400, 200]],
               counted_paths=1000, window_paths=10_000, n_spheres=8,
               backward=False)
    assert readers.glue_share(ctx) == pytest.approx(100 * 170 / 520)
    assert readers.device_idle(ctx) == pytest.approx(100 * (1 - 0.52))
    per = [[10 * v for v in row] for row in ctx["counts"]]
    least = C.kernel_least_seconds(10_000, per, 8, False)
    want = 100 * (least["k1"] + least["k6"]) / 350e-6
    assert readers.kernel_roofline(ctx) == pytest.approx(want)
    assert readers.kernel_roofline(dict(ctx, trace=None)) is None
    assert readers.glue_share(dict(ctx, trace=None)) is None
    # A share is never 0: a trace whose hand-written kernels the counts do
    # not cover (K3 here) gives no reading.
    only_k3 = trace.Trace([
        _event(trace.WINDOW, "user_annotation", 0, 100),
        _event("void spt::megakernel_bvh_kernel<false>(K3Params)", "kernel",
               10, 50)])
    assert only_k3.by_label == {"k3": pytest.approx(50e-6)}
    assert readers.kernel_roofline(dict(ctx, trace=only_k3)) is None


def test_k1_count_is_the_ports_arithmetic():
    c = dict(active=1800, hit=1300, shadow=1000, lit=500)
    want = (1000 * 38 + 1800 * 8 * 18 + 500 * 6 + 1300 * 116
            + 1000 * (142 + 8 * 18))
    assert C.k1_ops(1000, c, 8) == want
    assert C.k2_ops(1000, c, 8) == 2 * want - 1000 * 38 + 1300 * 270 \
        + 500 * 280
