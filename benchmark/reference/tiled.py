"""The tiled 3D engine, plain: tiles of a clamped grid over the volume
reflect-padded (mirrored without the edge voxel), each tile's ReLU'd
affinities times a Gaussian weight added into a canvas and the weight into a
weight map, the canvas divided by the map, the padding cut away."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import ops


def gaussian_weight(size, sigma: float = 0.2) -> np.ndarray:
    """1e-6 + exp(-d^2 / 2 sigma^2), d the distance from the centre over
    [-1, 1]^3."""
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in size]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt(zz * zz + yy * yy + xx * xx)
    return (1e-6 + np.exp(-(d ** 2) / (2.0 * sigma ** 2))).astype(np.float32)


def grid(shape, crop, stride) -> list:
    """Tile corners, z-major, each clamped to the volume, duplicates dropped."""
    num = [int(np.ceil((shape[d] - crop[d]) / stride[d])) + 1 for d in range(3)]
    out = []
    for iz in range(num[0]):
        for iy in range(num[1]):
            for ix in range(num[2]):
                pos = tuple(min(i * stride[d], shape[d] - crop[d])
                            for d, i in enumerate((iz, iy, ix)))
                if pos not in out:
                    out.append(pos)
    return out


@torch.no_grad()
def predict_volume(model, volume: np.ndarray, crop, stride, padding, batch: int,
                   device) -> torch.Tensor:
    """(12, D, H, W) float32 canvas of an eval-mode model's affinities."""
    pz, py, px = padding
    vol = torch.as_tensor(np.asarray(volume, np.float32), device=device)
    volp = F.pad(vol[None, None], (px, px, py, py, pz, pz), mode="reflect")[0, 0]
    shape = tuple(volp.shape)
    weight = torch.as_tensor(gaussian_weight(crop), device=device)
    canvas = torch.zeros((len(ops.SHIFTS_3D),) + shape, device=device)
    wmap = torch.zeros(shape, device=device)
    corners = grid(shape, crop, stride)
    table = ops.offsets_3d()
    for i in range(0, len(corners), batch):
        chunk = corners[i:i + batch]
        tiles = torch.stack([volp[z:z + crop[0], y:y + crop[1], x:x + crop[2]]
                             for z, y, x in chunk])[:, None]
        emb = model(tiles)[4].permute(0, 2, 3, 4, 1)
        affs = torch.relu(ops.affinities(emb, emb, table))
        for a, (z, y, x) in zip(affs, chunk):
            canvas[:, z:z + crop[0], y:y + crop[1], x:x + crop[2]] += a * weight
            wmap[z:z + crop[0], y:y + crop[1], x:x + crop[2]] += weight
    canvas /= wmap.clamp(min=1e-12)
    return canvas[:, pz:shape[0] - pz, py:shape[1] - py, px:shape[2] - px]
