"""The discriminative embedding loss, the port of the JAX package's
``ops/losses_extra.py::discriminative_loss`` (its other ablation losses
are not ported).

Pull/push/regularisation over instance centroids (delta_v 0.5, delta_d
1.5), with labels bucketed into a fixed number of instances and every pair
of centroids formed at once; background (0) is a cluster like any other by
default, as in the reference. Every square root is epsilon-guarded: the
pair distances include each centroid with itself and the centroid norms
include absent labels' zero means, whose unguarded gradients are NaN
(0 times NaN stays NaN in the cotangent).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def discriminative_loss(embedding_bhwc: torch.Tensor, seg_b: torch.Tensor,
                        max_instances: int = 64, delta_v: float = 0.5,
                        delta_d: float = 1.5, alpha: float = 1.0, beta: float = 1.0,
                        gamma: float = 0.001, include_background: bool = True) -> torch.Tensor:
    """alpha * pull + beta * push + gamma * reg of a (B, H, W, C) embedding
    (any strided view) against (B, H, W) integer labels, clipped into
    [0, max_instances); a 0-d tensor in the embedding's dtype."""
    b, h, w, c = embedding_bhwc.shape
    emb = embedding_bhwc.reshape(b, h * w, c)
    seg = seg_b.reshape(b, h * w).long()
    onehot = F.one_hot(seg.clamp(0, max_instances - 1), max_instances).to(emb.dtype)
    if not include_background:
        onehot = onehot * (seg > 0)[..., None].to(emb.dtype)
    counts = onehot.sum(dim=1)                                   # (B, K)
    present = counts > 0
    means = torch.einsum("bnk,bnc->bkc", onehot, emb) / counts.clamp(min=1.0)[..., None]
    num_id = present.sum(dim=1).to(emb.dtype)

    # pull: per label, the mean over its pixels of relu(|e - mu| - dv)^2
    mu = torch.einsum("bnk,bkc->bnc", onehot, means)
    dist = torch.sqrt(((emb - mu) ** 2).sum(dim=-1) + 1e-12)
    per_label = (torch.einsum("bnk,bn->bk", onehot, F.relu(dist - delta_v) ** 2)
                 / counts.clamp(min=1.0))
    var_loss = (per_label.sum(dim=1) / num_id.clamp(min=1.0)).mean()

    # push: every ordered pair of distinct present labels
    d = torch.sqrt(((means[:, :, None] - means[:, None, :]) ** 2).sum(dim=-1) + 1e-12)
    eye = torch.eye(max_instances, dtype=torch.bool, device=emb.device)
    pair_mask = present[:, :, None] & present[:, None, :] & ~eye[None]
    push = F.relu(2 * delta_d - d) ** 2 * pair_mask
    dist_loss = push.sum(dim=(1, 2)) / (num_id * (num_id - 1.0)).clamp(min=1.0) / 2.0
    dist_loss = torch.where(num_id > 1, dist_loss, torch.zeros_like(dist_loss)).mean()

    # regularisation of the centroids' norms
    reg = torch.sqrt((means ** 2).sum(dim=-1) + 1e-12) * present
    reg_loss = (reg.sum(dim=1) / num_id.clamp(min=1.0)).mean()
    return alpha * var_loss + beta * dist_loss + gamma * reg_loss
