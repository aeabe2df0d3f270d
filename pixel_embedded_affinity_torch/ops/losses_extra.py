"""The ablation losses of the JAX package's ``ops/losses_extra.py``, in
its layout (channels-last embeddings, channels-first affinities):

* ``discriminative_loss`` (scripts_cvppp/loss/loss_discriminative.py:7-63),
  the ResNet presets' extra term;
* the cosine-similarity affinities clamped to [0, 1] (mode 'official');
* the distance affinities (utils/emb2affs.py:63-75), replication-pad shifts;
* the rescaled (a + 1) / 2 affinities (the norm2 family);
* norm6: arbitrary (z, y, x) offsets through replication-pad shifts
  (scripts_ac3ac4/loss/loss_embedding_mse.py:346-365), with its EMA form;
* the BBBC 'orthogonal' variants (loss_embedding_orthogonal.py:7-37);
* the local cosine embedding loss (scripts_cvppp/loss/loss_local.py:53-131)
  and the host-side adjacency lists it consumes.

The discriminative loss: pull/push/regularisation over instance centroids (delta_v 0.5, delta_d
1.5), with labels bucketed into a fixed number of instances and every pair
of centroids formed at once; background (0) is a cluster like any other by
default, as in the reference. Every square root is epsilon-guarded: the
pair distances include each centroid with itself and the centroid norms
include absent labels' zero means, whose unguarded gradients are NaN
(0 times NaN stays NaN in the cotangent).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .emb2aff import _valid_mask_2d, normalize_embedding


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


def cosine_affinity_2d(embedding_bhwc: torch.Tensor, offsets, eps: float = 1e-6,
                       clamp: bool = True) -> torch.Tensor:
    """'official' cosine-similarity affinities (B, K, H, W), clamped to [0, 1],
    zero where p + o lies outside."""
    n = embedding_bhwc / torch.clamp(torch.linalg.vector_norm(embedding_bhwc, dim=-1,
                                                              keepdim=True), min=eps)
    h, w = n.shape[1], n.shape[2]
    chans = []
    for oy, ox in offsets:
        a = torch.sum(n * torch.roll(n, shifts=(-int(oy), -int(ox)), dims=(1, 2)), dim=-1)
        if clamp:
            a = torch.clamp(a, 0.0, 1.0)
        chans.append(a * _valid_mask_2d(h, w, int(oy), int(ox), a)[None])
    return torch.stack(chans, dim=1)


def _shift_replicate(x: torch.Tensor, off) -> torch.Tensor:
    """Replication-pad shift of a channels-last tensor: the value at p is
    x[clip(p + off)] along each spatial axis (axes 1 .. ndim-2)."""
    for axis, o in zip(range(1, x.dim() - 1), off):
        o = int(o)
        if o == 0:
            continue
        n = x.shape[axis]
        idx = torch.clamp(torch.arange(n, device=x.device) + o, 0, n - 1)
        x = torch.index_select(x, axis, idx)
    return x


def embeddings_to_affinities_distance(embedding: torch.Tensor, offsets,
                                      delta: float = 1.5) -> torch.Tensor:
    """Distance affinities ((2d - |e - e'|) / 2d, clamped at 0, squared),
    channels first, with replication-pad borders."""
    chans = []
    for off in offsets:
        dist = torch.linalg.vector_norm(embedding - _shift_replicate(embedding, off), dim=-1)
        chans.append(torch.clamp((2 * delta - dist) / (2 * delta), min=0.0) ** 2)
    return torch.stack(chans, dim=1)


def rescaled_affinity(affs: torch.Tensor) -> torch.Tensor:
    """(a + 1) / 2 clamped to [0, 1] (the norm2 family)."""
    return torch.clamp((affs + 1.0) / 2.0, 0.0, 1.0)


def affinity_norm6_3d(embedding_bdhwc: torch.Tensor, offsets,
                      ema_embedding: torch.Tensor | None = None) -> torch.Tensor:
    """norm6 affinities (B, K, D, H, W) for arbitrary (z, y, x) offsets:
    <n(p), n'(clip(p - o))> with n' the normalized EMA embedding where one
    is given (``offsets`` as in :func:`.offsets.shift_channels_offsets`)."""
    n = normalize_embedding(embedding_bdhwc)
    other = n if ema_embedding is None else normalize_embedding(ema_embedding)
    return torch.stack([torch.sum(n * _shift_replicate(other, [-int(o) for o in off]), dim=-1)
                        for off in offsets], dim=1)


def embedding_loss_norm6(embedding_bdhwc, target_bkdhw, weight_bkdhw, criterion, offsets,
                         ema_embedding=None):
    """(loss, affinities) of the norm6 path (embedding_loss_norm6 and its
    EMA form): ``criterion`` over all channels at once."""
    affs = affinity_norm6_3d(embedding_bdhwc, offsets, ema_embedding=ema_embedding)
    return criterion(affs, target_bkdhw, weight_bkdhw), affs


def orthogonal_affinity_2d(embedding_bhwc: torch.Tensor, offsets,
                           mode: str = "cos") -> torch.Tensor:
    """BBBC's 'orthogonal' affinities: circular-roll neighbours of the
    normalized embedding; ``mode="cos"`` (dot + 1) / 2, otherwise
    1 - |e - e'|^2 / 4; both clamped to [0, 1]. Channels first."""
    n = normalize_embedding(embedding_bhwc)
    chans = []
    for oy, ox in offsets:
        shifted = torch.roll(n, shifts=(-int(oy), -int(ox)), dims=(1, 2))
        if mode == "cos":
            a = (torch.sum(shifted * n, dim=-1) + 1.0) / 2.0
        else:
            a = 1.0 - torch.sum((shifted - n) ** 2, dim=-1) / 4.0
        chans.append(torch.clamp(a, 0.0, 1.0))
    return torch.stack(chans, dim=1)


def embedding_loss_orthogonal(embedding_bhwc, target_bkhw, weight_bkhw, mask_bkhw, criterion,
                              offsets, affs0_weight: float = 1.0, mode: str = "cos"):
    """(loss, affinities) of the orthogonal variant: per offset
    criterion(affs * mask, target * mask, weight), the first two offsets
    scaled by ``affs0_weight``."""
    affs = orthogonal_affinity_2d(embedding_bhwc, offsets, mode=mode)
    mask = mask_bkhw.to(affs.dtype)
    loss = 0.0
    for i in range(len(offsets)):
        li = criterion(affs[:, i] * mask[:, i], target_bkhw[:, i] * mask[:, i],
                       weight_bkhw[:, i])
        loss = loss + (li * affs0_weight if i < 2 else li)
    return loss, affs


def local_embedding_loss(embedding_bhwc: torch.Tensor, seg_bhw: torch.Tensor,
                         neighbor_bnm: torch.Tensor, include_bg: bool = True,
                         norm: bool = True) -> torch.Tensor:
    """The local cosine embedding loss, the mean over the batch.

    ``seg_bhw`` holds labels in [0, N]; ``neighbor_bnm`` (B, N, M)
    adjacency lists, row i - 1 the labels next to instance i, 0-padded
    (:func:`instance_neighbor_lists`). Labels are clipped to [0, N], so a
    map with more instances than rows merges the overflow into segment N
    without an error, as in the JAX package. Two quirks of the reference
    are kept, as the JAX package keeps them: the inter-instance term
    divides by ``sum(mask) + 1e12`` (loss_local.py:106, a typo for 1e-12
    there), and the inner term is ``+mean(cos(mu, e))`` (loss_local.py:79),
    which pushes pixels away from their own centroid."""
    b, h, w, e = embedding_bhwc.shape
    k = neighbor_bnm.shape[1] + 1  # label 0 = the background row, one row an instance
    if norm:
        embedding_bhwc = normalize_embedding(embedding_bhwc)
    cols = torch.arange(k, device=embedding_bhwc.device)
    losses = []
    for i in range(b):
        emb = normalize_embedding(embedding_bhwc[i].reshape(-1, e))
        lab = torch.clamp(seg_bhw[i].reshape(-1).long(), 0, k - 1)
        wpx = torch.ones_like(lab, dtype=emb.dtype) if include_bg else (lab > 0).to(emb.dtype)
        onehot = F.one_hot(lab, k).to(emb.dtype) * wpx[:, None]
        counts = onehot.sum(dim=0)
        present = counts > 0
        mu = normalize_embedding(onehot.t() @ emb / torch.clamp(counts, min=1.0)[:, None])
        cos_px = torch.sum(mu[lab] * emb, dim=-1)
        loss_inner = torch.sum(cos_px * wpx) / torch.clamp(torch.sum(wpx), min=1.0)
        pair = torch.abs(1.0 - mu @ mu.t())
        adj = F.one_hot(neighbor_bnm[i].long(), k).sum(dim=1) > 0
        indicator = torch.cat([(cols != 0)[None, :], adj | (cols == 0)[None, :]],
                              dim=0).to(emb.dtype)
        mask = indicator * present[:, None] * present[None, :]
        loss_inter = torch.sum(pair * mask) / (torch.sum(mask) + 1e12)  # (sic), as shipped
        losses.append(loss_inner + loss_inter)
    return torch.stack(losses).mean()


def instance_neighbor_lists(seg_hw, n_rows: int, m: int, dilate: int = 1,
                            strict: bool = False) -> np.ndarray:
    """The (n_rows, m) int32 adjacency lists of a label map, for
    :func:`local_embedding_loss`: instances a and b are neighbours when a
    pixel of a lies within ``dilate`` (Chebyshev) of a pixel of b; row
    i - 1 lists up to ``m`` neighbours of instance i, 0-padded. Labels above
    ``n_rows`` (which the loss would merge) and rows with more than ``m``
    neighbours (pairs the loss would miss) raise with ``strict`` and warn
    otherwise."""
    seg = np.asarray(seg_hw)
    max_lab = int(seg.max()) if seg.size else 0
    if max_lab > n_rows:
        msg = (f"instance_neighbor_lists: seg has labels up to {max_lab} but "
               f"n_rows={n_rows}; local_embedding_loss will clip-merge the "
               f"overflow instances")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    pairs = set()
    for dy in range(-dilate, dilate + 1):
        for dx in range(-dilate, dilate + 1):
            if dy == 0 and dx == 0:
                continue
            a = seg[max(0, dy):seg.shape[0] + min(0, dy),
                    max(0, dx):seg.shape[1] + min(0, dx)]
            b = seg[max(0, -dy):seg.shape[0] + min(0, -dy),
                    max(0, -dx):seg.shape[1] + min(0, -dx)]
            touch = (a != b) & (a > 0) & (b > 0)
            pairs.update(map(tuple, np.unique(np.stack([a[touch], b[touch]], axis=1), axis=0)))
    out = np.zeros((n_rows, m), dtype=np.int32)
    fill = {i: 0 for i in range(1, n_rows + 1)}
    dropped = 0
    for a, b in sorted(pairs):
        if 1 <= a <= n_rows:
            if fill[a] < m:
                out[a - 1, fill[a]] = b
                fill[a] += 1
            else:
                dropped += 1
    if dropped:
        msg = (f"instance_neighbor_lists: {dropped} adjacency pairs dropped "
               f"(rows full at m={m}); the loss's inter term will miss them")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    return out
