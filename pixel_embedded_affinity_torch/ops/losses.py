"""Embedding -> affinity losses and criteria (2D).

The formulas are the JAX package's ``ops/losses.py``, quirks included:

* ``weighted_mse`` normalises by B * prod(shape[2:]) of the tensor it is
  handed. The 2D per-offset call hands it (B, H, W), so the normaliser is
  B * W, not B * H * W: a constant loss scale the published checkpoints
  were trained under.
* ``ema_embedding_loss_2d`` scales the first two offsets by
  ``affs0_weight``.

``fuse_loss`` (with ``use_pallas`` and the WeightedMSE criterion) folds the
criterion into the loss-fused kernels (:mod:`.emb2aff_wmse_cuda`): their
forward gives the per-offset sums, their backward forms the loss cotangent
in registers. ``use_pallas=False`` is the plain path, differentiated by
autograd. Embeddings are (B, H, W, C) views; targets, weights and masks
(B, K, H, W).
"""

from __future__ import annotations

import numpy as np
import torch

from .emb2aff import cross_affinity_2d, embedding_to_affinity_2d
from .emb2aff_cuda import fused_affinity_2d
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


# the BCE criteria wait for the BBBC slice
CRITERIA = {"WeightedMSELoss": weighted_mse, "MSELoss": mse}


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
    if use_pallas and embedding_bhwc.device.type == "cuda":
        raise NotImplementedError(
            "the cross-affinity kernel pair K4f/K4b "
            "(emb2aff_pallas.py::fused_cross_affinity_2d) is not ported; "
            "use fuse_loss=True or use_pallas=False")
    # on the CPU the plain function stands in for K4, as for every kernel
    affs = cross_affinity_2d(embedding_bhwc, ema_embedding_bhwc, offsets)
    mask = mask_bkhw.to(affs.dtype)
    loss = 0.0
    for i in range(len(offsets)):
        li = criterion(affs[:, i] * mask[:, i], target_bkhw[:, i] * mask[:, i],
                       weightmap_bkhw[:, i])
        loss = loss + (li * affs0_weight if i < 2 else li)
    return loss, affs
