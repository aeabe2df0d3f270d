"""AC3/AC4 EM volumes for tiled serving, the JAX package's ``data/ac3ac4.py``
(``AC3AC4ValidVolume``, ``synthesize_volume``, the inverse of the EMA
view's 4-bit flip ``convert_consistency_flip_3d_rule4``), and
``label_affinities``, a synthetic canvas for the decoders. Volumes are HDF5 files with
one dataset ``main``: ``AC4_inputs.h5``/``AC4_labels.h5`` and
``AC3_inputs.h5``/``AC3_labels.h5`` in one folder."""

from __future__ import annotations

import os

import numpy as np
import torch

_FILES = {"ac4": ("AC4_inputs.h5", "AC4_labels.h5"),
          "ac3": ("AC3_inputs.h5", "AC3_labels.h5")}


def read_volume(data_folder: str, dataset_name: str = "ac4") -> tuple[np.ndarray, np.ndarray]:
    """(raw, label) of ``dataset_name``, each its HDF5 file's ``main``
    (h5py, imported here)."""
    import h5py

    out = []
    for name in _FILES[dataset_name]:
        with h5py.File(os.path.join(data_folder, name), "r") as f:
            out.append(f["main"][:])
    return tuple(out)


class AC3AC4ValidVolume:
    """A whole volume for tiled inference: ``raw`` float32 in [0, 1] and
    ``label`` int64, both (D, H, W).

    ``ac3`` serves its first 100 slices (the test split). ``ac4`` serves its
    last 20 slices when ``mode == "valid"`` (the validation split), and the
    whole volume in any other mode. ``arrays=(raw, label)`` stands in for
    the files (h5py is read only when they are)."""

    def __init__(self, data_folder: str, dataset_name: str = "ac4",
                 mode: str = "valid",
                 arrays: tuple[np.ndarray, np.ndarray] | None = None):
        raw, label = read_volume(data_folder, dataset_name) if arrays is None else arrays
        if dataset_name == "ac3":
            raw, label = raw[:100], label[:100]
        elif mode == "valid":
            raw, label = raw[-20:], label[-20:]
        self.raw = raw.astype(np.float32) / 255.0
        self.label = label.astype(np.int64)


def convert_consistency_flip_3d_rule4(emb_bdhwc: torch.Tensor,
                                      rules_b4: torch.Tensor) -> torch.Tensor:
    """Un-flip per-sample EMA embeddings (B, D, H, W, C) by their 4-bit rules
    (z, x, y, xy-transpose; H == W): the transpose, then the y-, x- and
    z-flips, each where the sample's bit is set. The result has the
    input's strides, as ``consistency.convert_consistency_flip``'s."""
    r = rules_b4.bool()

    def bit(i):
        return r[:, i, None, None, None, None]

    e = torch.where(~bit(3), emb_bdhwc, emb_bdhwc.transpose(2, 3))
    e = torch.where(bit(2), e.flip(2), e)
    e = torch.where(bit(1), e.flip(3), e)
    return torch.where(bit(0), e.flip(1), e)


def synthesize_volume(d=40, h=256, w=256, n_cells=40, seed=0):
    """Synthetic EM-like volume: random 3D Voronoi cells (z scaled by 4) with
    dark noisy boundaries. Returns (raw uint8, label int64), both (d, h, w)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.integers(0, d, n_cells), rng.integers(0, h, n_cells),
                    rng.integers(0, w, n_cells)], axis=1).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([zz.reshape(-1) * 4.0, yy.reshape(-1), xx.reshape(-1)],
                      axis=1).astype(np.float32)
    pts[:, 0] *= 4.0
    _, idx = cKDTree(pts).query(coords, workers=-1)
    label = (idx.reshape(d, h, w) + 1).astype(np.int64)

    raw = np.full((d, h, w), 180.0)
    boundary = np.zeros((d, h, w), bool)
    for axis in range(3):
        hi = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi[axis] = slice(1, None)
        lo[axis] = slice(0, -1)
        boundary[tuple(hi)] |= label[tuple(hi)] != label[tuple(lo)]
    raw[boundary] = 60.0
    raw += rng.normal(0, 15, raw.shape)
    return np.clip(raw, 0, 255).astype(np.uint8), label


def label_affinities(label: np.ndarray, seed: int = 0) -> np.ndarray:
    """A noisy affinity canvas (12, D, H, W) float32 from a label volume,
    for exercising the decoders on real segment counts: 1 where a voxel and
    its shift-table neighbour share a label, 0 across a boundary or off the
    volume; then squeezed into [0.1, 0.9] with seeded Gaussian noise
    (sigma 0.15), clipped to [0, 1], so the decoders have ties to break."""
    from ..ops.offsets import offsets_3d

    affs = np.zeros((12,) + label.shape, np.float32)
    for k, off in enumerate(offsets_3d()):
        axis, s = int(np.nonzero(off)[0][0]), -sum(off)
        hi = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi[axis], lo[axis] = slice(s, None), slice(0, label.shape[axis] - s)
        affs[k][tuple(hi)] = label[tuple(hi)] == label[tuple(lo)]
    noise = np.random.default_rng(seed).normal(0, 0.15, affs.shape)
    return np.clip(0.1 + 0.8 * affs + noise, 0, 1).astype(np.float32)
