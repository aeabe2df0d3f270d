"""Throughput metering and device tracing (the JAX package's
``utils/profiling.py``): a megapixels-a-second meter that skips warm-up
steps, and a ``torch.profiler`` trace of the CPU and the card written as a
Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time


class ThroughputMeter:
    """Items (e.g. megapixels) a second, counted from the ``warmup``-th call
    of :meth:`step` on."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.items = 0.0
        self.t0 = None

    def step(self, n_items: float):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
            self.items = 0.0
        elif self.count > self.warmup:
            self.items += n_items

    @property
    def rate(self) -> float:
        if self.t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.perf_counter() - self.t0)


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card around the block, written to ``<log_dir>/trace.json`` (Chrome's
    trace format) when it ends; no-op for ``log_dir`` None. Yields the
    profiler (None for no-op)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
