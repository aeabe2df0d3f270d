"""Shared model utilities (NCHW, NCDHW): align-corners upsampling, edge
padding, BatchNorms (2D and 3D) whose running statistics follow Flax's, and
convolutions that compute in another dtype than their parameters' (Flax's
``dtype`` beside its ``param_dtype``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.upsample_cuda import UpsampleAlignCorners


class _FlaxRunningStats:
    """A torch BatchNorm whose train-mode running variance takes the
    biased batch variance, as Flax's ``BatchNorm`` does; torch's takes the
    unbiased one (n / (n - 1) larger). Flax's ``momentum=m`` is torch's
    ``momentum=1 - m``. The parameters and buffers are torch's, so state
    dicts load unchanged.

    Torch's op writes rv' = (1 - m) rv + m c v with c = n / (n - 1), here
    into a copy of the buffer (autograd keeps the tensor it was given, so
    the buffer itself must not change under it); the buffer then takes
    (1 - m) rv + m v = rv' / c + (1 - 1/c) (1 - m) rv: two ops on a (C,)
    vector, with no second pass over the activations."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        inv_c = (n - 1) / n
        with torch.no_grad():
            self.running_var.mul_((1 - inv_c) * (1 - self.momentum)).add_(rv, alpha=inv_c)
        return y


class _CastConv:
    """A conv whose input, weight and bias are cast to ``compute_dtype`` at
    each call and whose output is in that dtype, as Flax's
    ``nn.Conv(dtype=...)`` promotes them; the parameters keep their dtype,
    and autograd returns their gradients in it. ``compute_dtype`` None (the
    default) computes in the parameters' dtype."""

    compute_dtype: torch.dtype | None = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_CastConv, nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype (:class:`_CastConv`)."""


class Conv3d(_CastConv, nn.Conv3d):
    """``nn.Conv3d`` with a compute dtype (:class:`_CastConv`)."""


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of ``model`` (a torch dtype or "float32" /
    "bfloat16") as Flax's ``dtype`` rule has it: every conv computes in it
    (float32: in its parameters' dtype, so ``model.double()`` computes in
    float64), each BatchNorm normalises its input in float32 and writes
    its output in its input's dtype, which F.batch_norm does for a bfloat16
    input beside float32 parameters, and pooling, upsampling and the adds
    keep their inputs' dtype. Returns ``model``."""
    dt = DTYPES[dtype] if isinstance(dtype, str) else dtype
    if dt not in DTYPES.values():
        raise ValueError(f"compute dtype {dtype}: expected float32 or bfloat16")
    model.compute_dtype = dt
    for m in model.modules():
        if isinstance(m, _CastConv):
            m.compute_dtype = None if dt == torch.float32 else dt
    return model


class BatchNorm2d(_FlaxRunningStats, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's running statistics; Flax's default
    ``momentum=0.9`` is torch's default 0.1."""


class BatchNorm3d(_FlaxRunningStats, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with Flax's running statistics."""


def upsample_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsampling with align_corners=True (nn.Upsample semantics),
    with a backward that gives the same bits on every run
    (:class:`..ops.upsample_cuda.UpsampleAlignCorners`)."""
    return UpsampleAlignCorners.apply(x)


def upsample_xy_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 linear upsampling of an NCDHW tensor along y and x only, with
    align_corners=True (the reference's ``nn.Upsample(scale_factor=(1, 2, 2),
    mode='trilinear', align_corners=True)``). At a z scale of 1 the
    align-corners source of slice z is exactly z, so z is copied as is. The
    backward is deterministic, as :func:`upsample_align_corners`'s."""
    return UpsampleAlignCorners.apply(x)


def replication_pad_to(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Edge-replicate pad the bottom/right of an NCHW tensor up to target size
    (the reference's ReplicationPad2d fix for odd skip shapes)."""
    ph, pw = target_h - x.shape[-2], target_w - x.shape[-1]
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, pw, 0, ph), mode="replicate")
