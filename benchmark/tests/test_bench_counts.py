"""The yardstick's arithmetic on fixed inputs."""

import pytest

from benchmark import counts, trace


def test_loop_bound_counts_operations_and_bytes():
    # 39 pairs of 480x640, every pair running all 10 x 30 steps, each
    # followed by its stop check, and 10 medians: operations 56 per step,
    # 5 per check and 2 x 150 per median, per pixel; bytes 16 float32
    # planes per pair
    b, h, w = 39, 480, 640
    steps, medians = b * 300, b * 10
    ops = (steps * 61 + medians * 300) * h * w
    t, by = counts.loop_bound_s(b, h, w, steps, medians, steps)
    assert by == "operations"
    assert t == pytest.approx(ops / 67e12)
    # a loop whose pairs all stop at once is bound by its bytes
    t, by = counts.loop_bound_s(b, h, w, b, b, b)
    assert by == "bytes"
    assert t == pytest.approx(16 * 4 * b * h * w / 3.35e12)
    # the block rule checks once a block, not once a step
    one = (300 * 56 + 10 * 5 + 10 * 300) * 100 / 67e12
    assert counts.loop_bound_s(1, 10, 10, 300, 10, 10)[0] == \
        pytest.approx(one)
    assert counts.tvl1_bound_s([(1, 10, 10, 300, 10, 10)] * 2) == \
        pytest.approx(2 * one)


def test_idle_formula():
    assert counts.idle_share(0.8, 1.0) == pytest.approx(20.0)


def test_trace_reduction_names_gaps_by_host_span():
    spans = trace.Spans()
    spans.items = [("clip", 10.0, 10.011), ("segmentation", 10.001, 10.004)]
    # device events in us: the marker at 0, kernels at 1000-2000 and
    # 5000-6000 (overlapping 5500-7000), idle from 7000 to the end (10500)
    events = [("marker", 0.0, 10.0), ("k1(float*)", 1000.0, 2000.0),
              ("k2(float*)", 5000.0, 6000.0), ("k2(float*)", 5500.0, 7000.0)]
    out = trace.reduce_events(events, 10.0, 10.0105, spans)
    assert out["busy_s"] == pytest.approx((10 + 1000 + 2000) / 1e6)
    assert out["window_s"] == pytest.approx(0.0105)
    assert out["kernels"]["k2(float*)"][0] == 2
    gaps = out["breakdown"]["idle_gaps"]
    # the tail 7000-10500 us lies in the clip only, 2000-5000 in
    # segmentation (10.001-10.004 s), 10-1000 before it
    assert gaps == [["clip", pytest.approx(0.0035)],
                    ["segmentation", pytest.approx(0.003)],
                    ["clip", pytest.approx(0.00099)]]
    assert out["breakdown"]["device_ops"][0][0] == "k2(float*)"
    with pytest.raises(RuntimeError):
        trace.reduce_events([], 0.0, 1.0, spans)


def test_kernel_names_match_whole():
    assert trace.kernel_matches(
        "void (anonymous namespace)::outer_loop_kernel<5>(float*)",
        "outer_loop_kernel")
    assert trace.kernel_matches("outer_loop_kernel(float const*, int)",
                                "outer_loop_kernel")
    assert not trace.kernel_matches("my_outer_loop_kernel(float*)",
                                    "outer_loop_kernel")
    kernels = {"outer_loop_kernel(float*)": (25, 0.2),
               "median5x5_kernel(float*)": (2, 0.01), "gemm(float*)": (9, 1)}
    assert trace.device_seconds(kernels, ["outer_loop_kernel",
                                          "median5x5_kernel"]) == \
        pytest.approx(0.21)
