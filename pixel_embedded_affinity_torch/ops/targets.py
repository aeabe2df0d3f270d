"""Training targets from label maps, built on the device.

The port of the JAX package's ``ops/affinity_jax.py``: from (B, H, W)
integer labels (2D) or (B, D, H, W) ones (3D), the affinity targets,
their masks (2D), the class-balancing weights and the four pyramid levels
that the deep-supervision heads read. The rules carried over:

* ``gen_affs``: target 1 where the labels at p and p + offset agree; where
  p + offset lies outside the image the target is ``padding`` and the mask
  is 0;
* ``weight_binary_ratio``: inverse class-frequency weights per (b, k)
  plane, the fraction clipped to [0.05, 0.99], and a uniform plane gets
  all ones;
* ``label_pyramid``: nearest-neighbour /2^k levels sized with Python's
  ``round`` (banker's rounding), as cv2's INTER_NEAREST sizes them;
* 3D: the 12-channel shift table's targets are 1 where the labels at p
  and p + o agree and both are foreground, 0 where p + o lies outside;
  one weight fraction per (b, k) volume; the pyramid halves y and x only,
  and its unit-shift targets fill each axis's leading face with the
  foreground mask (the reference's pad='replicate').
"""

from __future__ import annotations

import numpy as np
import torch

from .emb2aff import _valid_mask_2d
from .offsets import SHIFTS_3D, offsets_3d


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


def weight_binary_ratio(target: torch.Tensor, alpha: float = 1.0, dims=(-2, -1)) -> torch.Tensor:
    """Inverse class-frequency weights, one fraction per (b, k) plane
    (2D, ``dims=(-2, -1)``) or volume (3D, ``dims=(-3, -2, -1)``)."""
    binary = (target != 0).to(torch.float32)
    # the mean as XLA takes it, the sum times the float32 reciprocal of the
    # count, so the weights agree with the JAX package's to the last bit
    n = int(np.prod([target.shape[d] for d in dims]))
    frac = binary.sum(dim=dims, keepdim=True) * float(np.float32(1) / np.float32(n))
    uniform = (torch.amax(target, dim=dims, keepdim=True)
               == torch.amin(target, dim=dims, keepdim=True))
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


def _aff_channel_3d(labels: torch.Tensor, off) -> torch.Tensor:
    """(B, D, H, W) labels -> one float32 channel: 1 where the labels at p
    and p + off agree and both are > 0; 0 where p + off lies outside."""
    shifted = torch.roll(labels, shifts=tuple(-int(o) for o in off), dims=(1, 2, 3))
    eq = (labels == shifted) & (labels > 0) & (shifted > 0)
    valid = torch.ones(labels.shape[1:], dtype=torch.bool, device=labels.device)
    for axis, o in enumerate(off):
        n = labels.shape[1 + axis]
        idx = torch.arange(n, device=labels.device)
        v = (idx >= -o) if o < 0 else (idx < n - o)
        shape = [1, 1, 1]
        shape[axis] = n
        valid = valid & v.reshape(shape)
    return (eq & valid).to(torch.float32)


def seg_to_aff_3d_12ch(labels_bdhw: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """(B, D, H, W) integer labels -> (B, 12, D, H, W) targets of the
    interleaved (z, y, x) shift table."""
    return torch.stack([_aff_channel_3d(labels_bdhw, o) for o in offsets_3d(shifts)], dim=1)


def seg_to_aff_3d_unit(labels_bdhw: torch.Tensor) -> torch.Tensor:
    """(B, 3, D, H, W) unit-shift targets; each axis's leading face takes
    the foreground mask."""
    fg = (labels_bdhw > 0).to(torch.float32)
    chans = []
    for axis, off in enumerate(offsets_3d((1, 1, 1))):
        a = _aff_channel_3d(labels_bdhw, off)
        face = [slice(None)] * 4
        face[1 + axis] = slice(0, 1)
        a[tuple(face)] = fg[tuple(face)]
        chans.append(a)
    return torch.stack(chans, dim=1)


def label_pyramid_xy(labels_bdhw: torch.Tensor, num_levels: int = 4) -> list:
    """Nearest-neighbour levels halving y and x, k = 1..num_levels."""
    h, w = labels_bdhw.shape[2], labels_bdhw.shape[3]
    return [labels_bdhw[:, :, :: 2 ** k, :: 2 ** k][:, :, :round(h * 2.0 ** -k),
                                                    :round(w * 2.0 ** -k)]
            for k in range(1, num_levels + 1)]


def build_targets_3d(labels_bdhw: torch.Tensor):
    """(affs, wmap, downs) for the 3D train step: the 12-channel targets and
    their weights, (B, 12, D, H, W), and ``downs[k]`` = (unit-shift targets,
    weights), each (B, 3, D, H / 2^(k+1), W / 2^(k+1)), of pyramid level
    k + 1. The JAX package stacks each level's pair along channels."""
    dims = (-3, -2, -1)
    affs = seg_to_aff_3d_12ch(labels_bdhw)
    downs = []
    for lab in label_pyramid_xy(labels_bdhw, 4):
        a = seg_to_aff_3d_unit(lab)
        downs.append((a, weight_binary_ratio(a, dims=dims)))
    return affs, weight_binary_ratio(affs, dims=dims), downs
