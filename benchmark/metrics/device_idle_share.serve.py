"""device_idle_share.serve: the share of the traced stretch of whole volumes served
in which no kernel, copy or memset ran on the card: 100 (1 - union of their
intervals / window)."""

from benchmark.trace import busy_seconds, in_window


def read(record):
    if not in_window(record) or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(record) / record["window_s"])
