"""Embedding -> multi-offset affinity, plain PyTorch.

Embeddings are channels-last (B, H, W, C) or (B, D, H, W, C); affinities
are channels-first (B, K, H, W) or (B, K, D, H, W), one channel per offset.
Channel k at pixel p is the dot product of the L2-normalized embeddings at
p and p + offsets[k].

Border modes:
* ``'valid'``: the affinity is 0 where p + offset lies outside the image.
  This is what the CUDA kernels (:mod:`.emb2aff_cuda`,
  :mod:`.emb2aff_wmse_cuda`) compute.
* ``'circular'``: ``torch.roll`` wrap-around, the reference 2D loss's
  semantics; differs from 'valid' only in the wrap band.
"""

from __future__ import annotations

import torch

from .offsets import SHIFTS_3D, offsets_3d


def normalize_embedding(e: torch.Tensor, dim: int = -1,
                        eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize with the norm clamped to ``eps``.

    The squared norm gets a 1e-36 floor before the sqrt so the gradient at
    an all-zero vector is 0 instead of NaN; the forward change is < 1e-18.
    """
    norm = torch.sqrt(torch.sum(e * e, dim=dim, keepdim=True) + 1e-36)
    return e / torch.clamp(norm, min=eps)


def _valid_mask_2d(h: int, w: int, oy: int, ox: int,
                   like: torch.Tensor) -> torch.Tensor:
    ys = torch.arange(h, device=like.device)[:, None] + oy
    xs = torch.arange(w, device=like.device)[None, :] + ox
    return ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)).to(like.dtype)


def embedding_to_affinity_2d(embedding: torch.Tensor, offsets, normalize: bool = True,
                             padding: str = "valid") -> torch.Tensor:
    """(B, H, W, C) embeddings -> (B, K, H, W) affinities.

    affs[:, k, y, x] = <N[y, x], N[y + oy_k, x + ox_k]>, N the embedding
    L2-normalised along C, or as it is without ``normalize``.
    """
    if padding not in ("valid", "circular"):
        raise ValueError(f"padding must be 'valid' or 'circular', got {padding!r}")
    n = normalize_embedding(embedding) if normalize else embedding
    h, w = n.shape[1], n.shape[2]
    chans = []
    for off in offsets:
        oy, ox = int(off[0]), int(off[1])
        # neighbor value at p is n[p + off]: roll content by -off
        shifted = torch.roll(n, shifts=(-oy, -ox), dims=(1, 2))
        a = torch.sum(n * shifted, dim=-1)
        if padding == "valid":
            a = a * _valid_mask_2d(h, w, oy, ox, a)[None]
        chans.append(a)
    return torch.stack(chans, dim=1)


def cross_affinity_2d(embedding: torch.Tensor, other: torch.Tensor, offsets,
                      normalize: bool = True,
                      padding: str = "valid") -> torch.Tensor:
    """Cross-view affinities (B, K, H, W): <N_a[p], N_b[p + offset]>.

    The EMA-consistency loss dots the student embedding against the
    offset-shifted teacher embedding. Plain and differentiable: the oracle
    of the cross-view kernels (:mod:`.emb2aff_wmse_cuda`).
    """
    if padding not in ("valid", "circular"):
        raise ValueError(f"padding must be 'valid' or 'circular', got {padding!r}")
    n_a = normalize_embedding(embedding) if normalize else embedding
    n_b = normalize_embedding(other) if normalize else other
    h, w = n_a.shape[1], n_a.shape[2]
    chans = []
    for off in offsets:
        oy, ox = int(off[0]), int(off[1])
        shifted = torch.roll(n_b, shifts=(-oy, -ox), dims=(1, 2))
        a = torch.sum(n_a * shifted, dim=-1)
        if padding == "valid":
            a = a * _valid_mask_2d(h, w, oy, ox, a)[None]
        chans.append(a)
    return torch.stack(chans, dim=1)


def _neighbour(x: torch.Tensor, off) -> torch.Tensor:
    """(B, D, H, W, C) -> the same shape, whose value at p is x[p + off],
    0 where p + off lies outside the volume."""
    if any(abs(int(o)) >= n for o, n in zip(off, x.shape[1:4])):
        return torch.zeros_like(x)
    oz, oy, ox = (int(o) for o in off)
    # a negative pad crops: F.pad lists the last axis first
    return torch.nn.functional.pad(x, (0, 0, -ox, ox, -oy, oy, -oz, oz))


def offset_affinity_3d(n_a: torch.Tensor, n_b: torch.Tensor, offsets) -> torch.Tensor:
    """(B, K, D, H, W): channel k at p is <n_a(p), n_b(p + offsets[k])>, 0
    where p + offsets[k] lies outside; ``offsets`` are (dz, dy, dx). The
    vectors are dotted as given: the callers normalise them."""
    return torch.stack([torch.sum(n_a * _neighbour(n_b, o), dim=-1) for o in offsets], dim=1)


def embedding_to_affinity_3d(embedding: torch.Tensor, shifts=SHIFTS_3D,
                             normalize: bool = True) -> torch.Tensor:
    """(B, D, H, W, C) embeddings -> (B, K, D, H, W) affinities.

    Channel i dots each voxel with its neighbour ``shifts[i]`` back along
    axis i % 3 of (z, y, x); where that neighbour lies outside the volume
    the affinity is 0. The embedding is L2-normalised along C first, or
    taken as it is without ``normalize``. The oracle of the 3D kernels
    (:mod:`.emb2aff3d_cuda`).
    """
    n = normalize_embedding(embedding) if normalize else embedding
    return offset_affinity_3d(n, n, offsets_3d(shifts))


def cross_affinity_3d(a: torch.Tensor, b: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """Cross-view 3D affinities (B, K, D, H, W): <n_a(p), n_b(p - s_k e_{k%3})>,
    0 where the neighbour lies outside. The norm5 EMA-consistency loss dots
    the student embedding ``a`` against the shifted teacher ``b``. Plain
    and differentiable: the oracle of the cross-view kernels."""
    return offset_affinity_3d(normalize_embedding(a), normalize_embedding(b), offsets_3d(shifts))
