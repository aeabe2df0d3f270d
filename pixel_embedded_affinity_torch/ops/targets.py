"""Training targets from label maps, built on the device.

The port of the JAX package's ``ops/affinity_jax.py`` (2D part): from
(B, H, W) integer labels, the affinity targets, their masks, the
per-plane class-balancing weights and the four pyramid levels that the
deep-supervision heads read. The rules carried over:

* ``gen_affs``: target 1 where the labels at p and p + offset agree; where
  p + offset lies outside the image the target is ``padding`` and the mask
  is 0;
* ``weight_binary_ratio``: inverse class-frequency weights per (b, k)
  plane, the fraction clipped to [0.05, 0.99], and a uniform plane gets
  all ones;
* ``label_pyramid``: nearest-neighbour /2^k levels sized with Python's
  ``round`` (banker's rounding), as cv2's INTER_NEAREST sizes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .emb2aff import _valid_mask_2d


def gen_affs(labels_bhw: torch.Tensor, offsets, padding: bool = True,
             ignore: bool = False):
    """(B, H, W) integer labels -> (affs, masks), both (B, K, H, W) float32."""
    h, w = labels_bhw.shape[1], labels_bhw.shape[2]
    like = torch.empty(0, dtype=torch.float32, device=labels_bhw.device)
    affs, masks = [], []
    for off in offsets:
        oy, ox = int(off[0]), int(off[1])
        shifted = torch.roll(labels_bhw, shifts=(-oy, -ox), dims=(1, 2))
        valid = _valid_mask_2d(h, w, oy, ox, like)
        eq = (labels_bhw == shifted).to(torch.float32)
        if ignore:
            eq = eq * (labels_bhw != 0) * (shifted != 0)
        affs.append(torch.where(valid[None].bool(), eq, 1.0 if padding else 0.0))
        masks.append(valid[None].expand(labels_bhw.shape))
    return torch.stack(affs, dim=1), torch.stack(masks, dim=1)


def weight_binary_ratio(target_bkhw: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Per-(b, k)-plane inverse class-frequency weights."""
    binary = (target_bkhw != 0).to(torch.float32)
    # the mean as XLA takes it, the sum times the float32 reciprocal of the
    # count, so the weights agree with the JAX package's to the last bit
    n = target_bkhw.shape[-2] * target_bkhw.shape[-1]
    frac = binary.sum(dim=(-2, -1), keepdim=True) * float(np.float32(1) / np.float32(n))
    uniform = (torch.amax(target_bkhw, dim=(-2, -1), keepdim=True)
               == torch.amin(target_bkhw, dim=(-2, -1), keepdim=True))
    frac = torch.clamp(frac, 5e-2, 0.99)
    w_hi = binary + alpha * frac / (1.0 - frac) * (1.0 - binary)
    w_lo = alpha * (1.0 - frac) / frac * binary + (1.0 - binary)
    w = torch.where(frac > 0.5, w_hi, w_lo)
    return torch.where(uniform, torch.ones_like(w), w)


def label_pyramid(labels_bhw: torch.Tensor, num_levels: int = 4) -> list:
    """Nearest-neighbour /2^k levels, k = 1..num_levels."""
    h, w = labels_bhw.shape[1], labels_bhw.shape[2]
    out = []
    for k in range(1, num_levels + 1):
        oh, ow = round(h * 2.0 ** -k), round(w * 2.0 ** -k)
        out.append(labels_bhw[:, :: 2 ** k, :: 2 ** k][:, :oh, :ow])
    return out


def build_targets_2d(labels_bhw: torch.Tensor, offsets, neighbor: int = 4,
                     padding: bool = True):
    """(affs, wmap, mask, downs) for the 2D train step. ``downs[k]`` is
    (affs, weights, masks) of pyramid level k + 1 with the first
    ``neighbor // 2 * (4 - k)`` offsets: the JAX package stacks the three
    along channels; kept apart, each is contiguous, as the kernels take
    them."""
    nb_half = neighbor // 2
    affs, mask = gen_affs(labels_bhw, offsets, padding=padding)
    wmap = weight_binary_ratio(affs)
    downs = []
    for lvl, lab in enumerate(label_pyramid(labels_bhw, 4)):
        n_off = nb_half * (4 - lvl)
        a, m = gen_affs(lab, offsets[:n_off], padding=padding)
        downs.append((a, weight_binary_ratio(a), m))
    return affs, wmap, mask, downs
