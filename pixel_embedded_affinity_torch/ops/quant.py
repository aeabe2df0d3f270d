"""int8 post-training quantization for the serving fast forward, the port of
the JAX package's ``ops/quant.py``.

Symmetric int8: weights with one scale per output channel over the
prepared kernel (after the BatchNorm fold and the s2d transform, so it
composes with every kernel form of :mod:`..models.fast_forward`),
activations with one static scale per site, calibrated as max|x| (or a
quantile of |x|) over calibration images. The int32 accumulator is exact;
the two roundings are the only error. :func:`conv_i8` and
:func:`quantize_act` are the wrappers of the kernels I8c and I8q
(:mod:`.conv_i8_cuda`), which run their plain versions on a CPU tensor.
"""

from __future__ import annotations

import torch

from .conv_i8_cuda import I8Weights, conv_i8, pack_weights_i8, quantize_act

__all__ = ["I8Weights", "act_scale_from_absmax", "conv_i8", "pack_weights_i8",
           "quantize_act", "quantize_weights_per_cout"]


def quantize_weights_per_cout(w: torch.Tensor):
    """(..., Cout) float kernel -> (int8 kernel, float32 (Cout,) scale):
    ``s = max(max|w[..., c]|, 1e-12) / 127`` and ``clip(round(w / s), -127,
    127)``, in float32."""
    w = w.float()
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = absmax.clamp_min(1e-12) / 127.0
    return torch.round(w / scale).clamp_(-127, 127).to(torch.int8), scale


def act_scale_from_absmax(absmax: float) -> float:
    """The static activation scale of a calibrated max|x|."""
    return max(float(absmax), 1e-12) / 127.0
