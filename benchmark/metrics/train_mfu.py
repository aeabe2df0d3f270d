"""train_mfu: the training step's model FLOPs over the traced window, as a
share of the card's dense TF32 peak (the highest rate at which the tensor
cores take float32 operands, so no float32 step can pass it).

A step counts 4 forwards of the configuration's model at the cell's batch:
the student's forward and backward (3), and the teacher's forward (1).
"""


def read(record):
    peak = (record.get("peaks") or {}).get("tf32")
    flops, steps = record.get("step_flops"), record.get("steps")
    if not peak or not flops or not steps or record["window_s"] <= 0:
        return None
    return 100.0 * flops * steps / record["window_s"] / peak
