"""Mean-teacher EMA weights and the consistency ramps.

The JAX package's ``utils/ema.py`` (the reference's utils/utils.py:49-81):
``update_ema_variables`` with alpha = min(1 - 1/(t + 1), decay) for the
sharing_weights=False mean-teacher mode, here on state dicts (or any
mapping of tensors), and the sigmoid, linear and cosine ramps.
"""

from __future__ import annotations

import numpy as np
import torch


def update_ema_variables(params, ema_params, alpha: float, global_step: int) -> dict:
    """The teacher's new weights, ``e * a + p * (1 - a)`` for each entry of
    the state dicts ``ema_params`` and ``params`` (same keys), with ``a =
    min(1 - 1/(global_step + 1), alpha)``; a new dict, the inputs
    untouched. Integer entries (BatchNorm's ``num_batches_tracked``) take
    the student's value."""
    a = min(1.0 - 1.0 / (global_step + 1), alpha)
    if set(params) != set(ema_params):
        raise KeyError("the two state dicts have different keys")
    out = {}
    for k, e in ema_params.items():
        p = params[k]
        out[k] = (e * a + p * (1.0 - a)) if torch.is_floating_point(e) else p.clone()
    return out


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    current = np.clip(current, 0.0, rampup_length)
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    if rampup_length == 0:
        return 1.0
    return float(np.clip(current / rampup_length, 0.0, 1.0))


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))
