"""Shared model utilities (NCHW): align-corners upsampling, edge padding."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
