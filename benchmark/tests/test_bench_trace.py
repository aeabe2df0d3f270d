"""The trace arithmetic and the metric readers on synthetic traces."""

import pytest

from benchmark import harness, trace

PEAKS = {"tf32": 495e12, "hbm": 3.35e12}


def _record(device, window=(0.0, 1000.0), host=(), **extra):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for name, cat, ts, dur in device]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for name, cat, ts, dur in host]
    events.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0})
    rec = trace.reduce_trace(events)
    rec.update(extra)
    return rec


def read(name, record):
    return harness.metric_reader(name)(record)


def test_busy_time_is_the_union_of_intervals_clipped_to_the_window():
    rec = _record([("k1", "kernel", 100, 200), ("k2", "kernel", 150, 100),  # overlap: 100-300
                   ("cp", "gpu_memcpy", 500, 100), ("ms", "gpu_memset", 950, 100)])  # 950-1000
    assert trace.busy_seconds(rec) == pytest.approx((200 + 100 + 50) * 1e-6)
    assert rec["window_s"] == pytest.approx(1e-3)
    assert read("device_idle_share.train", rec) == pytest.approx(100 * (1 - 0.35))
    assert read("device_idle_share.serve", rec) == pytest.approx(100 * (1 - 0.35))
    assert trace.idle_gaps(rec) == [[0.0, 100.0], [300.0, 500.0], [600.0, 950.0]]


def test_a_sum_of_kernel_times_would_overcount_where_kernels_overlap():
    rec = _record([("a", "kernel", 0, 1000), ("b", "kernel", 0, 1000)])
    assert read("device_idle_share.train", rec) == pytest.approx(0.0)


def test_readers_report_nothing_where_there_is_nothing_to_read():
    rec = _record([], steps=4, step_flops=1e12, peaks=PEAKS)
    assert read("device_idle_share.train", rec) is None
    assert read("kernels_per_step.train", rec) is None
    assert read("conv2d_bwd_roofline.train", dict(rec, conv2d_shapes=[(1, 1, 1, 1, 1, 1, 1, 1)],
                                                   layers={"conv2d_bwd": ["wgrad"]})) is None
    assert read("train_mfu", dict(rec, peaks=None)) is None
    assert read("serve_mfu", rec) is None


def test_kernels_per_step_counts_kernels_only():
    rec = _record([("k", "kernel", i * 10, 5) for i in range(12)]
                  + [("cp", "gpu_memcpy", 900, 5)], steps=4)
    assert read("kernels_per_step.train", rec) == 3.0


def test_mfu_is_the_flops_over_the_window_at_the_tf32_peak():
    rec = _record([("k", "kernel", 0, 10)], window=(0.0, 2e6), steps=8, step_flops=1.2375e14,
                  peaks=PEAKS)
    assert read("train_mfu", rec) == pytest.approx(100.0)
    rec = _record([("k", "kernel", 0, 10)], window=(0.0, 1e6), tiles=10, tile_flops=4.95e12,
                  peaks=PEAKS)
    assert read("serve_mfu", rec) == pytest.approx(10.0)


def test_conv_backward_roofline_counts_work_from_shapes_and_time_from_named_kernels():
    # one 3x3 conv, 2x64x32x32 -> 64, whose input needs a gradient
    shapes = [(2, 64, 32, 32, 64, 3, 3, True)]
    macs = 2 * 32 * 32 * 64 * 64 * 9
    ops = 2 * 2 * macs
    nbytes = 4 * 2 * (2 * 64 * 32 * 32 * 2 + 64 * 64 * 9)
    dev = [("void wgrad_wgmma_kernel<128>", "kernel", 0, 30),
           ("sm90_xmma_dgrad_implicit_gemm", "kernel", 40, 20),
           ("batch_norm_backward", "kernel", 100, 500)]
    rec = _record(dev, steps=1, conv2d_shapes=shapes, peaks=PEAKS,
                  layers={"conv2d_bwd": ["wgrad_wgmma_kernel", "dgrad"]})
    bound = max(ops / PEAKS["tf32"], nbytes / PEAKS["hbm"])
    assert read("conv2d_bwd_roofline.train", rec) == pytest.approx(100 * bound / 50e-6)
    # the image conv's input gradient is not work
    shapes = [(2, 3, 32, 32, 64, 3, 3, False)]
    rec = _record(dev, steps=1, conv2d_shapes=shapes, peaks=PEAKS,
                  layers={"conv2d_bwd": ["wgrad_wgmma_kernel", "dgrad"]})
    w = harness.load_file_module(
        harness.os.path.join(harness.BENCH, "metrics", "conv2d_bwd_roofline.train.py"),
        "roofline").work
    assert w(shapes)[0] == 2 * 2 * 32 * 32 * 3 * 64 * 9


def test_breakdown_names_the_longest_operations_and_gaps_by_host_activity():
    dev = [("big", "kernel", 0, 300), ("small", "kernel", 400, 50), ("big", "kernel", 800, 100)]
    host = [("bench.call", "user_annotation", 0, 1000), ("bench.draw", "user_annotation", 290, 200),
            ("aten::index_select", "cpu_op", 440, 20)]
    rec = _record(dev, host=host)
    b = trace.breakdown(rec)
    assert b["device_ops"][0] == ["big", pytest.approx(400e-6)]
    assert b["idle_gaps"][0] == ["bench.draw / aten::index_select", pytest.approx(350e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce_trace([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}])
