"""conv2d_bwd_roofline.train: the 2D conv backward of the training step as a
share of its roofline.

Work, from the model's conv shapes (``record["conv2d_shapes"]``: batch,
input channels, height, width, output channels, kernel height and width, and
whether the input needs a gradient), per step: each conv's weight gradient
and, except where its input is the image, its input gradient, 2 x MACs each.
Bytes: each operand read once and each gradient written once, float32 (the
weight gradient reads x and dy and writes dW; the input gradient reads dy and
W and writes dx). Time: the kernels named in ``layers/conv2d_bwd/*.txt``.
Share: max(ops / TF32 peak, bytes / HBM bandwidth) / time. The work is the
same whatever implements it.
"""

from benchmark.trace import kernel_time

BYTES = 4


def work(shapes) -> tuple:
    """(ops, bytes) of one step's conv backward."""
    ops = nbytes = 0
    for n, cin, h, w, cout, kh, kw, need_dx in shapes:
        macs = n * h * w * cin * cout * kh * kw
        x, dy, wt = n * cin * h * w, n * cout * h * w, cout * cin * kh * kw
        ops += 2 * macs
        nbytes += (x + dy + wt) * BYTES
        if need_dx:
            ops += 2 * macs
            nbytes += (dy + wt + x) * BYTES
    return ops, nbytes


def read(record):
    peaks = record.get("peaks") or {}
    shapes, steps = record.get("conv2d_shapes"), record.get("steps")
    patterns = (record.get("layers") or {}).get("conv2d_bwd")
    if not peaks.get("tf32") or not shapes or not steps or not patterns:
        return None
    secs = kernel_time(record, patterns)
    if secs <= 0:
        return None
    ops, nbytes = work(shapes)
    bound = max(ops / peaks["tf32"], nbytes / peaks["hbm"]) * steps
    return 100.0 * bound / secs
