"""kernels_per_step.train: the device kernels the profiler recorded over the
traced stretch of training calls, those of CUDA-graph replays included,
divided by the steps in it."""

from benchmark.trace import in_window


def read(record):
    steps = record.get("steps")
    kernels = sum(1 for _, cat, _, _ in in_window(record) if cat == "kernel")
    if not steps or not kernels:
        return None
    return kernels / steps
