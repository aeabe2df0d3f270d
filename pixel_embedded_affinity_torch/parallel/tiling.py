"""Sliding-window tiled 3D inference with Gaussian-blended overlap.

The port of the JAX package's ``parallel/tiling.py`` (its per-batch
``TiledInference3D.run``): the volume is uploaded once and reflect-padded on
the device; tiles of a clamped (z, y, x) grid are cut on the device and run
through the predictor ``batch_size`` at a time; each tile's prediction times
a Gaussian weight is added into a float32 canvas, and the weight into a
weight map, tile by tile in grid order; the canvas is divided by the weight
map on the device and fetched once. The last batch is short: no tile is
predicted or added twice. In eager PyTorch this loop already queues every
batch with no host synchronisation, so the JAX package's one-dispatch
sweeps (``run_device_resident``) are not ported.

With a data-parallel ``mesh`` (JAX's tile parallelism, ``_shard_tiles``)
each rank predicts its contiguous part of every tile batch, a ragged last
batch included, and adds it into its own canvas and weight map; the two
are all-reduced once at the end, and every rank returns the whole canvas.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.profiling import span
from .mesh import all_reduce_sum_, split_positions


def gaussian_blend_weight(out_size, sigma: float = 0.2, mu: float = 0.0):
    """exp(-(d - mu)^2 / 2 sigma^2) of the distance d from the centre over
    normalized [-1,1]^3 coords (+1e-6 floor)."""
    zz, yy, xx = np.meshgrid(
        np.linspace(-1, 1, out_size[0], dtype=np.float32),
        np.linspace(-1, 1, out_size[1], dtype=np.float32),
        np.linspace(-1, 1, out_size[2], dtype=np.float32), indexing="ij")
    dd = np.sqrt(zz * zz + yy * yy + xx * xx)
    return (1e-6 + np.exp(-((dd - mu) ** 2) / (2.0 * sigma ** 2))).astype(np.float32)


def regular_grid_dims(padded_shape, crop_size, stride):
    """(nz, ny, nx) when the clamped grid is exactly regular, else None
    (AC3's padded 108x1120x1120 at crop (18,160,160), stride (10,80,80)
    gives (10,13,13); AC4's validation 28x1120x1120 gives (2,13,13))."""
    ns = []
    for d in range(3):
        r = padded_shape[d] - crop_size[d]
        if r < 0 or r % stride[d]:
            return None
        ns.append(r // stride[d] + 1)
    return tuple(ns)


def tile_grid(padded_shape, crop_size, stride):
    """Clamped tile start positions covering the padded volume, z-major,
    duplicates from the clamping dropped."""
    num = [int(np.ceil((padded_shape[d] - crop_size[d]) / stride[d])) + 1
           for d in range(3)]
    out = []
    seen = set()
    for iz in range(num[0]):
        for iy in range(num[1]):
            for ix in range(num[2]):
                pos = tuple(min(i * stride[d], padded_shape[d] - crop_size[d])
                            for d, i in enumerate((iz, iy, ix)))
                if pos not in seen:
                    seen.add(pos)
                    out.append(pos)
    return out


class TiledInference3D:
    """Runs ``predict_fn`` over tiles and stitches a (K, D, H, W) canvas,
    each tile weighted by :func:`gaussian_blend_weight` at ``sigma``.

    predict_fn: (B, 1, d, h, w) float32 tiles on the device -> (B, K, d, h, w)
    affinities on the device.

    ``mesh`` (:mod:`.mesh`): split every tile batch over its ranks (the
    module's docstring); ``batch_size`` must divide by its world size.
    """

    def __init__(self, crop_size=(18, 160, 160), stride=(10, 80, 80),
                 padding=(4, 48, 48), sigma: float = 0.2, batch_size: int = 8, mesh=None):
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size={batch_size} does not divide over "
                             f"{mesh.size} ranks")
        self.mesh = mesh
        self.crop_size = tuple(crop_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.batch_size = batch_size
        self.weight = gaussian_blend_weight(self.crop_size, sigma=sigma)

    def run(self, volume: np.ndarray, predict_fn: Callable, n_channels: int,
            device=None) -> np.ndarray:
        """(D, H, W) volume -> (n_channels, D, H, W) float32 canvas, on
        ``device`` (the mesh's when there is one)."""
        with span("pea.tiled.run"):
            mesh = self.mesh
            dev = mesh.device if mesh is not None else resolve_device(device)
            pz, py, px = self.padding
            cz, cy, cx = self.crop_size
            vol = torch.as_tensor(np.asarray(volume, np.float32)).to(dev)
            # np.pad(mode="reflect") semantics: mirror without the edge voxel
            volp = F.pad(vol[None, None], (px, px, py, py, pz, pz), mode="reflect")[0, 0]
            pshape = tuple(volp.shape)
            positions = tile_grid(pshape, self.crop_size, self.stride)
            weight = torch.from_numpy(self.weight).to(dev)
            canvas = torch.zeros((n_channels,) + pshape, dtype=torch.float32, device=dev)
            wmap = torch.zeros(pshape, dtype=torch.float32, device=dev)
            bs = self.batch_size
            for i0 in range(0, len(positions), bs):
                chunk = positions[i0:i0 + bs]
                chunk = chunk[split_positions(len(chunk), mesh)]
                if not chunk:  # this rank's part of a ragged last batch
                    continue
                with span("pea.tiled.cut"):
                    tiles = torch.stack([volp[z:z + cz, y:y + cy, x:x + cx]
                                         for z, y, x in chunk])[:, None]
                with span("pea.tiled.predict"):
                    affs = predict_fn(tiles)
                with span("pea.tiled.stitch"):
                    for a, (z, y, x) in zip(affs, chunk):
                        canvas[:, z:z + cz, y:y + cy, x:x + cx] += a * weight
                        wmap[z:z + cz, y:y + cy, x:x + cx] += weight
            inner = (slice(pz, pshape[0] - pz), slice(py, pshape[1] - py),
                     slice(px, pshape[2] - px))
            with span("pea.tiled.fetch"):
                if mesh is not None and mesh.size > 1:
                    # the interior of canvas and weight map, summed over the ranks at once
                    both = all_reduce_sum_(mesh, torch.cat([canvas[(slice(None),) + inner],
                                                            wmap[inner][None]]))
                    return (both[:-1] / both[-1].clamp_(min=1e-12)).cpu().numpy()
                canvas /= wmap.clamp_(min=1e-12)
                return canvas[(slice(None),) + inner].cpu().numpy()
