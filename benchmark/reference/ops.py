"""Affinities, training targets, losses and the teacher's un-flip, written
plainly from the method's description (Pixel-Embedded Affinity, its CVPPP and
AC3/AC4 scripts).

Embeddings are channels-last (B, H, W, C) or (B, D, H, W, C); affinities,
targets and weights channels-first (B, K, H, W) or (B, K, D, H, W). An
affinity is the dot product of the L2-normalised embeddings at p and at
p + offset, 0 where p + offset lies outside. The weighted MSE divides by
B * prod(shape[2:]) of what it is handed, which for a 2D offset's (B, H, W)
plane is B * W: the published loss scale.
"""

from __future__ import annotations

import numpy as np
import torch

SHIFTS_3D = (1, 1, 1, 2, 3, 3, 3, 9, 9, 4, 27, 27)


def offsets_2d(shifts, neighbor: int = 4) -> list:
    """[-s, 0], [0, -s] per shift (neighbor 4), and [-s, -s], [-s, s] with 8."""
    out = []
    for s in shifts:
        out += [[-s, 0], [0, -s]] + ([[-s, -s], [-s, s]] if neighbor == 8 else [])
    return out


def offsets_3d(shifts=SHIFTS_3D) -> list:
    """Channel i shifts axis i % 3 of (z, y, x) by -shifts[i]."""
    out = []
    for i, s in enumerate(shifts):
        off = [0, 0, 0]
        off[i % 3] = -int(s)
        out.append(off)
    return out


def normalize(e: torch.Tensor) -> torch.Tensor:
    """L2 along the last axis; the norm floored at 1e-12."""
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)


def neighbour(x: torch.Tensor, off) -> torch.Tensor:
    """x[p + off] along x's spatial axes (1 .. n), 0 outside."""
    out = torch.zeros_like(x)
    src, dst = [slice(None)], [slice(None)]
    for o, n in zip(off, x.shape[1:1 + len(off)]):
        o = int(o)
        if abs(o) >= n:
            return out
        src.append(slice(max(o, 0), n + min(o, 0)))
        dst.append(slice(max(-o, 0), n + min(-o, 0)))
    out[tuple(dst)] = x[tuple(src)]
    return out


def affinities(a: torch.Tensor, b: torch.Tensor, offsets) -> torch.Tensor:
    """(B, K, ...) channel k: <N(a)[p], N(b)[p + offsets[k]]>, 0 outside."""
    na, nb = normalize(a), normalize(b)
    return torch.stack([torch.sum(na * neighbour(nb, o), dim=-1) for o in offsets], dim=1)


def inside_mask(shape, off, device) -> torch.Tensor:
    """1.0 where p + off lies inside ``shape``."""
    m = torch.ones(shape, device=device)
    for axis, o in enumerate(off):
        idx = torch.arange(shape[axis], device=device) + int(o)
        v = ((idx >= 0) & (idx < shape[axis])).float()
        m = m * v.reshape([-1 if i == axis else 1 for i in range(len(shape))])
    return m


def weighted_mse(pred, target, weight):
    norm = pred.shape[0] * int(np.prod(pred.shape[2:]))
    return torch.sum(weight * (pred - target) ** 2) / norm


def binary_ratio_weights(target: torch.Tensor, dims) -> torch.Tensor:
    """Inverse class-frequency weights per plane (2D) or volume (3D): with f
    the positive share clipped to [0.05, 0.99], positives 1 and negatives
    f / (1 - f) where f > 0.5, else positives (1 - f) / f and negatives 1;
    all ones where the plane is uniform."""
    pos = (target != 0).float()
    f = torch.clamp(pos.mean(dim=dims, keepdim=True), 0.05, 0.99)
    hi = pos + f / (1 - f) * (1 - pos)
    lo = (1 - f) / f * pos + (1 - pos)
    w = torch.where(f > 0.5, hi, lo)
    uniform = target.amax(dim=dims, keepdim=True) == target.amin(dim=dims, keepdim=True)
    return torch.where(uniform, torch.ones_like(w), w)


# ------------------------------------------------------------------- 2D

def targets_2d(seg: torch.Tensor, offsets):
    """(affs, masks) (B, K, H, W): 1 where the labels at p and p + offset
    agree, 1 outside (masked out)."""
    h, w = seg.shape[1:]
    affs, masks = [], []
    for off in offsets:
        inside = inside_mask((h, w), off, seg.device)
        eq = (seg == neighbour(seg, off)).float()
        affs.append(torch.where(inside.bool(), eq, torch.ones_like(eq)))
        masks.append(inside.expand(seg.shape))
    return torch.stack(affs, 1), torch.stack(masks, 1)


def pyramid_2d(seg: torch.Tensor, levels: int = 4) -> list:
    """Nearest /2^k levels, sized round(n / 2^k)."""
    h, w = seg.shape[1:]
    return [seg[:, ::2 ** k, ::2 ** k][:, :round(h / 2 ** k), :round(w / 2 ** k)]
            for k in range(1, levels + 1)]


def self_loss_2d(emb, target, weight, mask, offsets):
    affs = affinities(emb, emb, offsets)
    return sum(weighted_mse(affs[:, i] * mask[:, i], target[:, i] * mask[:, i], weight[:, i])
               for i in range(len(offsets)))


def cross_loss_2d(emb, teacher, target, weight, mask, offsets, affs0_weight: float = 1.0):
    affs = affinities(emb, teacher, offsets)
    total = 0.0
    for i in range(len(offsets)):
        li = weighted_mse(affs[:, i] * mask[:, i], target[:, i] * mask[:, i], weight[:, i])
        total = total + (li * affs0_weight if i < 2 else li)
    return total


def unflip_2d(e: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    """Undo the teacher's (x flip, y flip, transpose) rule per sample of (B,
    H, W, C): the transpose first, then the y and the x flip."""
    out = []
    for x, r in zip(e, rules.tolist()):
        if r[2]:
            x = x.transpose(0, 1)
        if r[1]:
            x = x.flip(0)
        if r[0]:
            x = x.flip(1)
        out.append(x)
    return torch.stack(out)


# ------------------------------------------------------------------- 3D

def targets_3d(seg: torch.Tensor, offsets) -> torch.Tensor:
    """(B, K, D, H, W): 1 where the labels at p and p + offset agree and both
    are foreground, 0 outside."""
    chans = []
    for off in offsets:
        nb = neighbour(seg, off)
        inside = inside_mask(seg.shape[1:], off, seg.device)
        chans.append(((seg == nb) & (seg > 0) & (nb > 0)).float() * inside)
    return torch.stack(chans, 1)


def unit_targets_3d(seg: torch.Tensor) -> torch.Tensor:
    """The unit shifts' targets; each axis's leading face takes the
    foreground mask."""
    t = targets_3d(seg, offsets_3d((1, 1, 1)))
    fg = (seg > 0).float()
    for axis in range(3):
        face = [slice(None)] * 4
        face[1 + axis] = slice(0, 1)
        t[(slice(None), axis) + tuple(face[1:])] = fg[tuple(face)]
    return t


def pyramid_xy(seg: torch.Tensor, levels: int = 4) -> list:
    h, w = seg.shape[2:]
    return [seg[:, :, ::2 ** k, ::2 ** k][:, :, :round(h / 2 ** k), :round(w / 2 ** k)]
            for k in range(1, levels + 1)]


def slab_loss_3d(affs, target, weight, shifts, affs0_weight: float = 1.0, scaled: int = 3):
    """Channel i's criterion over the slab where its neighbour lies inside
    (index >= shifts[i] along axis i % 3); the first ``scaled`` channels
    times ``affs0_weight`` (3 for the shift table, 1 for the unit shifts)."""
    total = 0.0
    for i, s in enumerate(shifts):
        axis = 2 + i % 3
        n = affs.shape[axis]

        def cut(x):
            return x[:, i:i + 1].narrow(axis, int(s), n - int(s))

        li = weighted_mse(cut(affs), cut(target), cut(weight))
        total = total + (li * affs0_weight if i < scaled else li)
    return total


def unflip_3d(e: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    """Undo the teacher's 4-bit (z, x, y, xy-transpose) rule per sample of
    (B, D, H, W, C): the transpose, then the y, x and z flips."""
    out = []
    for x, r in zip(e, rules.tolist()):
        if r[3]:
            x = x.transpose(1, 2)
        if r[2]:
            x = x.flip(1)
        if r[1]:
            x = x.flip(2)
        if r[0]:
            x = x.flip(0)
        out.append(x)
    return torch.stack(out)
