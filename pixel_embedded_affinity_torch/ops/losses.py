"""Embedding -> affinity losses and criteria (2D and 3D).

The formulas are the JAX package's ``ops/losses.py``, quirks included:

* ``weighted_mse`` normalises by B * prod(shape[2:]) of the tensor it is
  handed. The 2D per-offset call hands it (B, H, W), so the normaliser is
  B * W, not B * H * W: a constant loss scale the published checkpoints
  were trained under.
* ``ema_embedding_loss_2d`` scales the first two offsets by
  ``affs0_weight``.

* the 3D losses (``embedding_loss_norm1``, ``embedding_loss_norm5``)
  apply the criterion to each channel's sliced slab, the part of the
  volume where the neighbour lies inside, so its normaliser is
  B * D' * H' * W' of that slab; channels 0..2 are scaled by
  ``affs0_weight``.

``fuse_loss`` (with ``use_pallas`` and the WeightedMSE criterion) folds the
criterion into the loss-fused kernels (:mod:`.emb2aff_wmse_cuda`): their
forward gives the per-offset sums, their backward forms the loss cotangent
in registers. Unfused, ``use_pallas`` takes the 2D affinities from the
affinity kernels (:mod:`.emb2aff_cuda`: K1 self, K4 cross) and applies the
criterion to them. ``use_pallas=False`` is the plain path, differentiated
by autograd. Embeddings are (B, H, W, C) or (B, D, H, W, C) views;
targets, weights and masks (B, K, H, W) or (B, K, D, H, W). With
``use_pallas`` the norm5 affinities come from the 3D kernels
(:mod:`.emb2aff3d_cuda`).

``mask_head_loss`` is the BBBC mask head's class-weighted cross entropy,
with the reference's class-weight order (see its docstring).

Dtypes follow the JAX package's: a bfloat16 embedding goes to the kernels
as it is; fused, S is float32 and the affinities bfloat16; unfused, the
affinities are bfloat16 and the criterion promotes against the float32
targets and weights (``mask.to(affs.dtype)`` as in JAX), so every loss is
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .emb2aff import (cross_affinity_2d, cross_affinity_3d, embedding_to_affinity_2d,
                      embedding_to_affinity_3d, normalize_embedding, offset_affinity_3d)
from .emb2aff3d_cuda import fused_affinity_3d, fused_cross_affinity_3d
from .emb2aff_cuda import fused_affinity_2d, fused_cross_affinity_2d
from .offsets import SHIFTS_3D, offsets_3d
from .emb2aff_wmse_cuda import fused_affinity_wmse_2d, fused_cross_affinity_wmse_2d


def weighted_mse(pred, target, weight=None):
    """sum(w * (p - t)^2) / (B * prod(shape[2:])), the reference's normaliser."""
    norm = pred.shape[0] * (int(np.prod(pred.shape[2:])) if pred.dim() > 2 else 1)
    d = (pred - target) ** 2
    if weight is not None:
        d = weight * d
    return torch.sum(d) / norm


def mse(pred, target, weight=None):
    return torch.mean((pred - target) ** 2)


def _bce(pred, target, eps=1e-12):
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def bce(pred, target, weight=None):
    return torch.mean(_bce(pred, target))


def weighted_bce(pred, target, weight=None):
    b = _bce(pred, target)
    if weight is not None:
        b = weight * b
    return torch.mean(b)


CRITERIA = {"WeightedMSELoss": weighted_mse, "WeightedBCELoss": weighted_bce,
            "MSELoss": mse, "BCELoss": bce}


def mask_head_loss(logits_bhwc, target_mask_bhw, mesh=None):
    """Class-weighted cross entropy of the binary mask head: logits
    (B, H, W, 2), target (B, H, W) foreground mask.

    The reference weights class 0 by count(target == 1) and class 1 by
    count(target == 0), the pixel counts in that order, and, as torch's
    CrossEntropyLoss with class weights, divides by the sum of the
    samples' weights. The counts are float32 whatever the logits' dtype, as
    in the JAX package: with bfloat16 logits the log-probabilities are
    bfloat16 and the weighted sum float32.

    With a data-parallel ``mesh`` (world size N > 1) this rank holds a
    shard of the batch: the counts are the global batch's (one
    all-reduce), so is the sum of the weights, n_fg n_bg + n_bg n_fg, and
    the rank's term is N times its part of the global loss, so that the
    mean over the ranks, of the terms and of their gradients, is the global
    loss's."""
    t = target_mask_bhw.long()
    counts = torch.stack([torch.sum(t == 1), torch.sum(t == 0)]).to(torch.float32)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from ..parallel.mesh import all_reduce_sum_

        all_reduce_sum_(mesh, counts)
    w = counts[t]
    pick = torch.gather(torch.log_softmax(logits_bhwc, dim=-1), -1, t[..., None])[..., 0]
    if sharded:
        return -torch.sum(w * pick) * mesh.size / torch.clamp(2 * counts[0] * counts[1],
                                                               min=1e-12)
    return -torch.sum(w * pick) / torch.clamp(torch.sum(w), min=1e-12)


def _fused(criterion, use_pallas: bool, fuse_loss: bool) -> bool:
    return fuse_loss and use_pallas and criterion is weighted_mse


def embedding_loss_2d(embedding_bhwc, target_bkhw, weightmap_bkhw, mask_bkhw,
                      offsets, criterion=weighted_mse, use_pallas: bool = True,
                      fuse_loss: bool = False):
    """Self-affinity loss over all offsets. Returns (loss, affs (B, K, H, W)).

    Per offset k: criterion(affs_k * mask_k, target_k * mask_k, weight_k),
    summed over offsets. Fused, the affinities are non-differentiable
    (monitoring only) and the loss is sum(S) / (B * W).
    """
    if _fused(criterion, use_pallas, fuse_loss):
        s, affs = fused_affinity_wmse_2d(embedding_bhwc, target_bkhw, weightmap_bkhw,
                                         mask_bkhw.to(target_bkhw.dtype), offsets)
        b, w = embedding_bhwc.shape[0], embedding_bhwc.shape[2]
        return torch.sum(s) / (b * w), affs
    if use_pallas:
        affs = fused_affinity_2d(embedding_bhwc, offsets)
    else:
        affs = embedding_to_affinity_2d(embedding_bhwc, offsets, padding="valid")
    mask = mask_bkhw.to(affs.dtype)
    loss = 0.0
    for i in range(affs.shape[1]):
        loss = loss + criterion(affs[:, i] * mask[:, i],
                                target_bkhw[:, i] * mask[:, i],
                                weightmap_bkhw[:, i])
    return loss, affs


def ema_embedding_loss_2d(embedding_bhwc, ema_embedding_bhwc, target_bkhw,
                          weightmap_bkhw, mask_bkhw, offsets,
                          criterion=weighted_mse, affs0_weight: float = 1.0,
                          use_pallas: bool = False, fuse_loss: bool = False):
    """Cross-view loss: the student embedding dotted with the offset-shifted
    teacher. The caller passes a detached teacher (the reference detaches
    the un-flipped EMA view), so gradients reach only the student."""
    if _fused(criterion, use_pallas, fuse_loss):
        s, affs = fused_cross_affinity_wmse_2d(
            embedding_bhwc, ema_embedding_bhwc, target_bkhw, weightmap_bkhw,
            mask_bkhw.to(target_bkhw.dtype), offsets)
        b, w = embedding_bhwc.shape[0], embedding_bhwc.shape[2]
        coeff = torch.ones_like(s)
        coeff[:2] = affs0_weight
        return torch.sum(s * coeff) / (b * w), affs
    if use_pallas:
        affs = fused_cross_affinity_2d(embedding_bhwc, ema_embedding_bhwc, offsets)
    else:
        affs = cross_affinity_2d(embedding_bhwc, ema_embedding_bhwc, offsets)
    mask = mask_bkhw.to(affs.dtype)
    loss = 0.0
    for i in range(len(offsets)):
        li = criterion(affs[:, i] * mask[:, i], target_bkhw[:, i] * mask[:, i],
                       weightmap_bkhw[:, i])
        loss = loss + (li * affs0_weight if i < 2 else li)
    return loss, affs


def deep_supervision_losses_2d(embeddings, downs, offsets, neighbor: int = 4,
                               criterion=weighted_mse, use_pallas: bool = True):
    """The summed losses of the four auxiliary heads (scales 1/2 .. 1/16).
    ``embeddings`` = [emd1 (/2), emd2 (/4), emd3 (/8), emd4 (/16)],
    channels-last; ``downs[k]`` packs (affs | weights | masks) along its
    channel axis with ``neighbor // 2 * (4 - k)`` offsets each (the
    reference's main.py:284-287 layout), the first that many of
    ``offsets``."""
    nb_half = neighbor // 2
    total = 0.0
    for k, (emb, down) in enumerate(zip(embeddings, downs)):
        n_off = nb_half * (4 - k)
        t, w, m = down[:, 0:n_off], down[:, n_off:2 * n_off], down[:, 2 * n_off:3 * n_off]
        loss, _ = embedding_loss_2d(emb, t, w, m, offsets[:n_off], criterion=criterion,
                                    use_pallas=use_pallas)
        total = total + loss
    return total


def _slab(x: torch.Tensor, i: int, axis: int, s: int) -> torch.Tensor:
    """Channel i of (B, K, D, H, W), from index s on along spatial
    ``axis``, as (B, 1, D', H', W')."""
    return x[:, i:i + 1].narrow(2 + axis, s, x.shape[2 + axis] - s)


def _slab_loss_3d(affs, target, weight, i: int, axis: int, s: int, criterion):
    """The criterion over channel i's slab where the neighbour is inside."""
    return criterion(_slab(affs, i, axis, s), _slab(target, i, axis, s),
                     _slab(weight, i, axis, s))


def embedding_loss_norm1(embedding_bdhwc, target, weightmap, criterion=weighted_mse,
                         affs0_weight: float = 1.0, shift: int = 1,
                         ema_embedding_bdhwc=None):
    """Unit-shift 3D loss over (z, y, x): (loss, affs (B, 3, D, H, W)), the
    z channel scaled by ``affs0_weight``. With ``ema_embedding_bdhwc`` the
    cross-view variant (the student at p, the teacher at p - shift)."""
    n = normalize_embedding(embedding_bdhwc)
    n_lo = n if ema_embedding_bdhwc is None else normalize_embedding(ema_embedding_bdhwc)
    affs = offset_affinity_3d(n, n_lo, offsets_3d((shift,) * 3))
    loss = 0.0
    for axis in range(3):
        li = _slab_loss_3d(affs, target, weightmap, axis, axis, shift, criterion)
        loss = loss + (li * affs0_weight if axis == 0 else li)
    return loss, affs


def embedding_loss_norm5(embedding_bdhwc, target, weightmap, criterion=weighted_mse,
                         affs0_weight: float = 1.0, shifts=SHIFTS_3D,
                         ema_embedding_bdhwc=None, use_pallas: bool = True):
    """Shift-table 3D loss: (loss, affs (B, K, D, H, W)), channels 0..2
    scaled by ``affs0_weight``. With ``ema_embedding_bdhwc`` the cross-view
    variant. ``use_pallas``: the affinities through the 3D kernels."""
    if ema_embedding_bdhwc is None:
        affs = (fused_affinity_3d(embedding_bdhwc, shifts) if use_pallas
                else embedding_to_affinity_3d(embedding_bdhwc, shifts))
    else:
        affs = (fused_cross_affinity_3d(embedding_bdhwc, ema_embedding_bdhwc, shifts)
                if use_pallas else
                cross_affinity_3d(embedding_bdhwc, ema_embedding_bdhwc, shifts))
    loss = 0.0
    for i, s in enumerate(shifts):
        li = _slab_loss_3d(affs, target, weightmap, i, i % 3, int(s), criterion)
        loss = loss + (li * affs0_weight if i < 3 else li)
    return loss, affs
