"""The program-span readers on synthetic traces: idle time put down to the
innermost ``pea.`` span, host time inside spans, and nothing read where the
program records no spans."""

import pytest

from benchmark import harness, spans, trace

SPAN_METRICS = ("sample_host_ms.train", "sample_idle_ms.train", "ema_view_host_ms.train",
                "ema_view_idle_ms.train", "step_host_ms.train", "step_idle_ms.train")


def _record(device, host, window=(0.0, 1000.0), **extra):
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for name, cat, ts, dur in list(device) + list(host)]
    rec = trace.reduce_trace(events)
    rec.update(extra)
    return rec


def read(name, record):
    return harness.metric_reader(name)(record)


def _ann(name, ts, dur):
    return (name, "user_annotation", ts, dur)


def _two_steps():
    """Two steps of 500 µs: sample 0-100, step 100-500 holding ema_view
    120-220; kernels 50-80, 200-300, 400-450 and the same shifted by 500."""
    host, dev = [_ann("bench.call", 0, 1000)], []
    for s in (0, 500):
        host += [_ann("bench.draw", s, 100), _ann("pea.sample", s, 100),
                 _ann("bench.step", s + 100, 400), _ann("pea.step", s + 100, 400),
                 _ann("pea.ema_view", s + 120, 100),
                 ("aten::maximum", "cpu_op", s + 130, 40)]
        dev += [("k", "kernel", s + 50, 30), ("k", "kernel", s + 200, 100),
                ("cp", "gpu_memcpy", s + 400, 50)]
    return _record(dev, host, steps=2)


def test_idle_goes_to_the_innermost_span():
    rec = _two_steps()
    idle = spans.idle_us(rec)
    # a step: sample idle 0-50, 80-100; ema_view 120-200 (inside pea.step,
    # counted for the view alone); step 100-120, 300-400, 450-500
    assert idle == {"pea.sample": pytest.approx(140.0), "pea.ema_view": pytest.approx(160.0),
                    "pea.step": pytest.approx(340.0)}
    assert read("sample_idle_ms.train", rec) == pytest.approx(0.070)
    assert read("ema_view_idle_ms.train", rec) == pytest.approx(0.080)
    assert read("step_idle_ms.train", rec) == pytest.approx(0.170)


def test_host_time_inside_spans_and_the_step_less_its_view():
    rec = _two_steps()
    assert read("sample_host_ms.train", rec) == pytest.approx(0.100)
    assert read("ema_view_host_ms.train", rec) == pytest.approx(0.100)
    assert read("step_host_ms.train", rec) == pytest.approx(0.300)


def test_a_gap_across_two_spans_is_split_between_them():
    host = [_ann("pea.sample", 100, 200), _ann("pea.step", 300, 400),
            _ann("pea.ema_view", 350, 100)]
    rec = _record([("k", "kernel", 0, 150), ("k", "kernel", 900, 100)], host, steps=1)
    assert trace.idle_gaps(rec) == [[150.0, 900.0]]
    assert spans.idle_us(rec) == {"pea.sample": pytest.approx(150.0),
                                  "pea.step": pytest.approx(300.0),
                                  "pea.ema_view": pytest.approx(100.0),
                                  None: pytest.approx(200.0)}


def test_span_idle_and_idle_outside_sum_to_the_window_idle():
    host = [_ann("pea.sample", 10, 90), _ann("pea.step", 120, 300), _ann("pea.ema_view", 130, 50),
            _ann("pea.sample", 500, 60), _ann("pea.step", 580, 400),
            _ann("pea.ema_view", 600, 150), _ann("bench.step", 580, 400)]
    dev = [("k", "kernel", ts, 23) for ts in range(0, 1000, 61)]
    rec = _record(dev, host, steps=2)
    idle = spans.idle_us(rec)
    total = rec["window_s"] * 1e6 - trace.busy_seconds(rec) * 1e6
    assert sum(idle.values()) == pytest.approx(total)
    share = read("device_idle_share.train", rec)
    per_step = sum(read(m, rec) for m in SPAN_METRICS if "idle" in m)
    outside_ms = idle[None] * 1e-3
    assert (per_step * rec["steps"] + outside_ms) == pytest.approx(
        share / 100 * rec["window_s"] * 1e3)


def test_spans_are_clipped_to_the_window_and_other_annotations_ignored():
    host = [_ann("pea.sample", -100, 150), _ann("bench.step", 0, 1000),
            _ann("other.span", 0, 1000), ("pea.step", "cpu_op", 0, 1000)]
    rec = _record([], host, steps=1)
    assert spans.spans(rec) == [[0.0, 50.0, "pea.sample"]]
    assert spans.idle_us(rec) == {"pea.sample": pytest.approx(50.0), None: pytest.approx(950.0)}


def test_tile_batch_host_time_is_over_the_predict_spans():
    host = [_ann("pea.tiled.run", 0, 1000)]
    for i, t in enumerate((100, 400)):
        host += [_ann("pea.tiled.cut", t, 20), _ann("pea.tiled.predict", t + 20, 50 + i * 10),
                 _ann("pea.tiled.stitch", t + 100, 80)]
    host.append(_ann("pea.tiled.fetch", 800, 150))
    rec = _record([("k", "kernel", 0, 10)], host)
    assert read("tile_batch_host_ms.serve", rec) == pytest.approx((40 + 110 + 160) * 1e-3 / 2)


@pytest.mark.parametrize("metric", SPAN_METRICS + ("tile_batch_host_ms.serve",))
def test_readers_report_nothing_without_their_spans(metric):
    # the parent's trace: the benchmark's spans and device work, no program span
    host = [_ann("bench.call", 0, 1000), _ann("bench.draw", 0, 100),
            _ann("bench.step", 100, 800), ("aten::copy_", "cpu_op", 120, 30)]
    rec = _record([("k", "kernel", 200, 300)], host, steps=4)
    assert read(metric, rec) is None
    # another program span alone does not give this one a reading
    others = {"sample": "pea.step", "ema_view": "pea.step", "step": "pea.sample",
              "tile_batch": "pea.tiled.run"}
    other = others[metric.split("_host")[0].split("_idle")[0]]
    rec = _record([("k", "kernel", 200, 300)], host + [_ann(other, 100, 800)], steps=4)
    assert read(metric, rec) is None


def test_a_span_with_no_idle_reads_zero_not_nothing():
    rec = _record([("k", "kernel", 0, 1000)], [_ann("pea.sample", 100, 100),
                                               _ann("pea.step", 200, 100)], steps=1)
    assert read("sample_idle_ms.train", rec) == 0.0
    assert read("step_idle_ms.train", rec) == 0.0
    assert read("ema_view_idle_ms.train", rec) is None


def test_manifest_lists_the_span_metrics_in_the_cells_that_record_them():
    m = {p["name"]: p for p in harness.manifest()["per_layer"]}
    for name in SPAN_METRICS:
        assert m[name]["source"] == "program_span" and m[name]["better"] == "lower"
        assert m[name]["workloads"] == ["cvppp.train_graphed", "ac3ac4.train_graphed"]
        assert m[name]["moves"] == "train_samples_per_s"
    assert m["tile_batch_host_ms.serve"]["workloads"] == ["ac3ac4.serve_affinity"]
    assert m["tile_batch_host_ms.serve"]["moves"] == "serve_mvoxels_per_s"
