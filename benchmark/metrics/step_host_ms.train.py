"""step_host_ms.train: the host's ms a step inside the program's step call
(``pea.step``: the optimizer's scalars, the copies into the static buffers
and the graph's replay), less its EMA view (``pea.ema_view``), over the
traced stretch of training calls."""

from benchmark.spans import host_ms_per_step


def read(record):
    return host_ms_per_step(record, "pea.step", less=("pea.ema_view",))
