"""tile_batch_host_ms.serve: the host's ms a tile batch inside the tiled
engine's cut, predict and stitch spans (``pea.tiled.cut``,
``pea.tiled.predict``, ``pea.tiled.stitch``) over the traced volumes,
divided by the ``pea.tiled.predict`` spans (one a batch)."""

from benchmark.spans import host_us, spans

STAGES = ("pea.tiled.cut", "pea.tiled.predict", "pea.tiled.stitch")


def read(record):
    batches = len(spans(record, "pea.tiled.predict"))
    times = [host_us(record, name) for name in STAGES]
    if not batches or None in times:
        return None
    return sum(times) * 1e-3 / batches
