"""The traced stretch of a run and the arithmetic over its trace.

:func:`capture` runs a steady stretch of a cell's calls under
``torch.profiler`` with the card idle before and after, and reduces the
exported trace to a record: the window (the ``bench.window`` span), every
device activity (kernels, copies, memsets, those of graph replays included)
and the host's spans and operators. The readers in ``metrics/`` take their
numbers from such records, and the unit tests hand them synthetic ones.

Busy time is the union of the device intervals inside the window, so
overlapping kernels count once; the idle share is 1 - busy / window.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


def capture(fn, n: int, label: str = "bench.call") -> dict:
    """Run ``fn()`` ``n`` times, each in a ``label`` span, inside one
    ``bench.window`` span that opens and closes on an idle card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        sync()
        with record_function("bench.window"):
            for _ in range(n):
                with record_function(label):
                    fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return reduce_trace(events.get("traceEvents", []) if isinstance(events, dict) else events)


def reduce_trace(events: list) -> dict:
    """{"window": [t0, t1] µs, "window_s", "device": [[name, cat, ts, dur]],
    "host": [[name, cat, ts, dur]]} from chrome-trace events."""
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append([name, cat, ts, dur])
        elif cat in HOST_CATS:
            if name == "bench.window" and cat == "user_annotation":
                window = [ts, ts + dur]
            host.append([name, cat, ts, dur])
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return {"window": window, "window_s": (window[1] - window[0]) * 1e-6,
            "device": device, "host": host}


def in_window(record: dict) -> list:
    """The device activities of the window, clipped to it: [[name, cat, a, b]]."""
    t0, t1 = record["window"]
    out = []
    for name, cat, ts, dur in record["device"]:
        a, b = max(ts, t0), min(ts + dur, t1)
        if b > a:
            out.append([name, cat, a, b])
    return out


def union(intervals) -> list:
    """Merged [a, b] intervals, sorted."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(record: dict) -> float:
    return sum(b - a for a, b in union((a, b) for _, _, a, b in in_window(record))) * 1e-6


def idle_gaps(record: dict) -> list:
    """[[a, b]] µs of the window in which no device activity ran."""
    t0, t1 = record["window"]
    gaps, cur = [], t0
    for a, b in union((a, b) for _, _, a, b in in_window(record)):
        if a > cur:
            gaps.append([cur, a])
        cur = max(cur, b)
    if t1 > cur:
        gaps.append([cur, t1])
    return gaps


def host_label(record: dict, t: float) -> str:
    """What the host was doing at ``t``: its innermost benchmark span and
    innermost operator, "span / op"."""
    span, op = None, None
    for name, cat, ts, dur in record["host"]:
        if ts <= t < ts + dur:
            if cat == "user_annotation" and name != "bench.window":
                if span is None or ts >= span[1]:
                    span = (name, ts)
            elif cat == "cpu_op" and (op is None or ts >= op[1]):
                op = (name, ts)
    parts = [p[0] for p in (span, op) if p is not None]
    return " / ".join(parts) if parts else "host idle"


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    labelled by what the host was doing when each began, in seconds."""
    per_name: dict = {}
    for name, _, a, b in in_window(record):
        per_name[name] = per_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(record), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name[:200], s] for name, s in ops],
            "idle_gaps": [[host_label(record, a)[:200], (b - a) * 1e-6] for a, b in gaps]}


def kernel_time(record: dict, patterns) -> float:
    """Seconds of the window's kernels whose name holds one of ``patterns``."""
    return sum((b - a) * 1e-6 for name, cat, a, b in in_window(record)
               if cat == "kernel" and any(p in name for p in patterns))
