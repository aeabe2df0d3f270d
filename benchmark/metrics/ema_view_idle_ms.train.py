"""ema_view_idle_ms.train: the card's idle ms a step while the host's
innermost program span was the EMA view's (``pea.ema_view``), over the
traced stretch of training calls."""

from benchmark.spans import idle_ms_per_step


def read(record):
    return idle_ms_per_step(record, "pea.ema_view")
