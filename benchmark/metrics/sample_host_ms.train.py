"""sample_host_ms.train: the host's ms a step inside the program's sampler
(its ``pea.sample`` spans) over the traced stretch of training calls."""

from benchmark.spans import host_ms_per_step


def read(record):
    return host_ms_per_step(record, "pea.sample")
