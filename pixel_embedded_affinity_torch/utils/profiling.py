"""The port's spans and device tracing.

:class:`span` names a stretch of the port's host work (the sampler, the EMA
view, the step launch, the tiled engine's stages) on ``torch.profiler``'s
clock, so a trace puts each gap in the card's activity down to the routine
the host was in. A profiler that is recording is the only switch: without
one a span costs one check. :func:`trace_context` records such a trace of
the CPU and the card around a block, written as a Chrome trace (the JAX
package's ``utils/profiling.py`` writes its own)."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_profiler_enabled = torch._C._autograd._profiler_enabled


class span:
    """``with span("pea.step"): ...``: a ``torch.profiler.record_function``
    annotation named ``name`` (a ``user_annotation`` of the trace) while a
    profiler records on this thread; else nothing but the check."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card around the block, written to ``<log_dir>/trace.json`` (Chrome's
    trace format) when it ends; no-op for ``log_dir`` None. Yields the
    profiler (None for no-op). The port's spans record inside it."""
    if log_dir is None:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
