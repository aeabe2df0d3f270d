"""ema_view_host_ms.train: the host's ms a step inside the program's EMA
view (its ``pea.ema_view`` spans: the teacher's view and its flip rules
drawn on the card) over the traced stretch of training calls."""

from benchmark.spans import host_ms_per_step


def read(record):
    return host_ms_per_step(record, "pea.ema_view")
