"""Shared model utilities (NCHW, NCDHW): align-corners upsampling, edge
padding, BatchNorms (2D and 3D) whose running statistics follow Flax's and
whose train-mode statistics span the ranks of a data-parallel mesh
(:func:`bind_mesh`), and convolutions that compute in another dtype than
their parameters' (Flax's ``dtype`` beside its ``param_dtype``)."""

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

    mesh = None  # a data-parallel mesh (:func:`bind_mesh`)

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        if self.mesh is not None and self.mesh.size > 1:
            return self._cross_rank_forward(x)
        self.num_batches_tracked.add_(1)
        rv = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        inv_c = (n - 1) / n
        with torch.no_grad():
            self.running_var.mul_((1 - inv_c) * (1 - self.momentum)).add_(rv, alpha=inv_c)
        return y

    def _cross_rank_forward(self, x):
        """Train mode over the mesh's global batch, as GSPMD gives the JAX
        model: per channel one all-reduce of [sum x, sum x^2, n], the mean
        and Flax's variance E[x^2] - E[x]^2 of the global batch, the running
        statistics updated with them (the biased variance), and a backward
        that all-reduces [sum dy, sum dy x_hat] (:class:`_CrossRankNorm`).

        The sums are formed in float64 from this rank's mean and biased
        variance (``torch.var_mean``, in the statistics' dtype), so E[x^2] -
        E[x]^2 loses nothing to cancellation: in float32, where |mean| is
        large against the deviation, it loses up to a few 1e-4 of the
        gradient of a 4-rank step (measured on the CPU), a float64 pass
        over (C,) vectors does not."""
        from ..parallel.mesh import all_reduce_sum_

        self.num_batches_tracked.add_(1)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            var_r, mean_r = torch.var_mean(_stat_dtype(x), dims, correction=0)
            n_r = x.numel() // c
            mean_r, var_r = mean_r.double(), var_r.double()
            stats = torch.cat([mean_r * n_r, (var_r + mean_r * mean_r) * n_r,
                               mean_r.new_full((1,), n_r)])
            all_reduce_sum_(self.mesh, stats)
            n = stats[2 * c]
            mean64 = stats[:c] / n
            var64 = stats[c:2 * c] / n - mean64 * mean64
            dt = var_r.dtype if x.dtype == torch.float64 else torch.float32
            mean, var = mean64.to(dt), var64.to(dt)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1 - m).add_(var.to(self.running_var.dtype), alpha=m)
        return _CrossRankNorm.apply(x, self.weight, self.bias, mean, torch.rsqrt(var + self.eps),
                                    n.to(dt), self.mesh)


def _stat_dtype(x):
    """x in float32, or as it is in float64 (BatchNorm's statistics dtype)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


class _CrossRankNorm(torch.autograd.Function):
    """y = (x - mean) invstd w + b over the mesh's global statistics, in
    the statistics' dtype, written in x's. The backward is the gradient of
    the global batch's normalisation with respect to this rank's x: one
    all-reduce of [sum dy, sum dy x_hat]; w's and b's gradients are this
    rank's sums, which the step's gradient mean over the ranks completes."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, mesh):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = _stat_dtype(x)
        y = (xf - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mesh = mesh
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from ..parallel.mesh import all_reduce_sum_

        x, weight, mean, invstd, n = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        xhat = (_stat_dtype(x) - mean.view(shape)) * invstd.view(shape)
        g = _stat_dtype(dy)
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        total = all_reduce_sum_(ctx.mesh, local.clone()) / n
        dx = (weight * invstd).view(shape) * (g - total[:c].view(shape)
                                              - xhat * total[c:].view(shape))
        return (dx.to(dy.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None, None, None)


def bind_mesh(model: nn.Module, mesh) -> nn.Module:
    """Let every BatchNorm of ``model`` take its train-mode statistics over
    ``mesh``'s global batch (None: this process's batch). At world size 1
    nothing changes. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, _FlaxRunningStats):
            m.mesh = mesh
    return model


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
