"""Constrained MALIS loss weights (the native library), the JAX package's
``postproc/malis.py`` (the reference's scripts_ac3ac4/utils/malis_loss.py
and loss/loss_malis.py malisWeight): per-edge weight = opt_weight * the
positive maximin pair counts + (1 - opt_weight) * the negative ones, each
normalised by its total; loss = sum(weight * (affs - gt)^2). The weights are
computed on the host (sequential Kruskal)."""

from __future__ import annotations

import numpy as np

from ._native import get_lib


def malis_weights(affs: np.ndarray, seg: np.ndarray, opt_weight: float = 0.5) -> np.ndarray:
    """affs (3, D, H, W) predicted nearest-neighbour affinities (channel d
    the edge to -1 along axis d); seg (D, H, W) -> weights like affs."""
    affs = np.ascontiguousarray(affs, dtype=np.float32)
    seg = np.ascontiguousarray(seg, dtype=np.uint32)
    d, h, w = seg.shape
    out = np.zeros_like(affs)
    get_lib().malis_weights(affs.reshape(3, -1), seg.reshape(-1), d, h, w, float(opt_weight),
                            out.reshape(3, -1))
    return out


def malis_loss(output_affs: np.ndarray, gt_affs: np.ndarray, seg: np.ndarray,
               opt_weight: float = 0.5) -> float:
    """The scalar MALIS loss (malis_loss.py:5-14)."""
    weight = malis_weights(output_affs[:3], seg, opt_weight)
    return float(np.sum(weight * (output_affs[:3] - gt_affs[:3]) ** 2))
