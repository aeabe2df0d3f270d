"""Shared model utilities (NCHW): align-corners upsampling, edge padding,
and a BatchNorm whose running statistics follow Flax's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode running variance takes the
    biased batch variance, as Flax's ``BatchNorm`` does; torch's takes the
    unbiased one (n / (n - 1) larger). Flax's ``momentum=0.9`` is torch's
    default ``momentum=0.1``. The parameters and buffers are torch's, so
    state dicts load unchanged.

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


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsampling with align_corners=True (nn.Upsample semantics)."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=True)


def replication_pad_to(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Edge-replicate pad the bottom/right of an NCHW tensor up to target size
    (the reference's ReplicationPad2d fix for odd skip shapes)."""
    ph, pw = target_h - x.shape[-2], target_w - x.shape[-1]
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, pw, 0, ph), mode="replicate")
