"""Superpixel (SSN-style) soft pooling and the superpixel loss, the JAX
package's ``ops/spixel.py``:

* ``poolfeat`` / ``upfeat`` (scripts_cvppp/utils/train_utils.py:77-132,
  :134-180): 9-neighbour soft pixel <-> superpixel aggregation;
* ``compute_semantic_pos_loss`` (scripts_cvppp/model/loss_spixel.py:6-37):
  the semantic cross-entropy and positional L2 reconstructed through the
  soft assignment, with the reference's weights (0.005, pos_weight / S).

The layout is the reference's NCHW: feat (B, C, H, W), prob (B, 9, H, W)
(the JAX package keeps them channels-last). The 9 neighbour channels keep
the reference's row-major order: 0 top-left, 1 top, 2 top-right, 3 left,
4 centre, 5 right, 6 bottom-left, 7 bottom, 8 bottom-right.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (dy, dx) of each prob channel, in the reference's order (train_utils.py:92-126)
NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def _shift2d_zero(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i + dy, j + dx], zero out of range."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _avg_pool(x: torch.Tensor, sp_h: int, sp_w: int) -> torch.Tensor:
    b, c, h, w = x.shape
    if h % sp_h or w % sp_w:
        raise ValueError(f"poolfeat needs H,W divisible by the cell: {(h, w)} vs {(sp_h, sp_w)}")
    return x.reshape(b, c, h // sp_h, sp_h, w // sp_w, sp_w).mean(dim=(3, 5))


def poolfeat(feat: torch.Tensor, prob: torch.Tensor, sp_h: int = 2, sp_w: int = 2) -> torch.Tensor:
    """Soft pixel -> superpixel pooling: (B, C, H/sp_h, W/sp_w), for each cell
    the probability-weighted mean of the features of the pixels that point
    to it (a pixel of cell (i, j) reaches cell (i + dy, j + dx) through
    prob channel (dy, dx)), with the reference's 1e-8 mass guard."""
    ones = torch.ones_like(feat[:, :1])
    feat1 = torch.cat([feat, ones], dim=1)  # carry the probability mass
    acc = 0.0
    for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        pooled = _avg_pool(feat1 * prob[:, k:k + 1], sp_h, sp_w)
        acc = acc + _shift2d_zero(pooled, -dy, -dx)
    return acc[:, :-1] / (acc[:, -1:] + 1e-8)


def upfeat(feat: torch.Tensor, prob: torch.Tensor, up_h: int = 2, up_w: int = 2) -> torch.Tensor:
    """Soft superpixel -> pixel reconstruction: each pixel blends its 9
    candidate cells (nearest-upsampled, zero out of range) by its
    assignment probabilities. feat (B, C, h, w), prob (B, 9, h*up_h,
    w*up_w)."""
    out = 0.0
    for k, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
        up = torch.repeat_interleave(torch.repeat_interleave(
            _shift2d_zero(feat, dy, dx), up_h, dim=2), up_w, dim=3)
        out = out + up * prob[:, k:k + 1]
    return out


def compute_semantic_pos_loss(prob: torch.Tensor, labxy_feat: torch.Tensor,
                              pos_weight: float = 0.003, kernel_size: int = 16):
    """(loss, semantic term, positional term) of the superpixel loss.
    ``labxy_feat`` (B, C, H, W) has the one-hot semantics first and the (x,
    y) position features as its last two channels; the features are pooled
    to superpixels and reconstructed, the semantic term is the
    cross-entropy of the reconstruction, the positional term the per-pixel
    L2 of the position error times pos_weight / kernel_size, both scaled by
    0.005."""
    s = kernel_size
    b = labxy_feat.shape[0]
    reconstr = upfeat(poolfeat(labxy_feat, prob, s, s), prob, s, s)
    loss_map = reconstr[:, -2:] - labxy_feat[:, -2:]
    logit = torch.log(reconstr[:, :-2] + 1e-8)
    loss_sem = -torch.sum(logit * labxy_feat[:, :-2]) / b
    loss_pos = torch.sum(torch.sqrt(torch.sum(loss_map ** 2, dim=1))) / b * pos_weight / s
    return 0.005 * (loss_sem + loss_pos), 0.005 * loss_sem, 0.005 * loss_pos
