"""Watershed fragments (scipy + the native library), the JAX package's
``postproc/watershed.py``.

* ``watershed_from_affs``: per-slice seeded watershed on
  boundary = 1 - 0.5 * (affs_y + affs_x), seeded at the regional maxima of
  the distance transform of boundary < 0.5 (the JAX package's
  'maxima_distance', the one seed method its decoders use).
* ``distance_transform_watershed``: Gaussian-smoothed (sigma 2) distance
  transform of (hmap < 0.25), seeds = connected regional maxima, watershed
  on hmap (the multicut baseline's fragments).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ._native import get_lib


def seeded_watershed(cost: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """2D priority-flood watershed growing ``seeds`` over ascending ``cost``."""
    lib = get_lib()
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    out = np.zeros_like(seeds)
    h, w = cost.shape
    lib.seeded_watershed_2d(cost, seeds, h, w, out)
    return out


def _regional_maxima(x: np.ndarray) -> np.ndarray:
    """8-connected regional maxima, plateaus included: the pixels that are
    at least their 3x3 neighbourhood's maximum.

    The JAX package takes these candidates and then drops each 8-connected
    plateau whose 3x3 border holds a larger value. No plateau is ever
    dropped: each border pixel neighbours a plateau pixel, which is at least
    its neighbours. So the candidates are the result, without the loop over
    plateaus, whose cost grows with their number times the image size."""
    return x >= ndimage.maximum_filter(x, size=3, mode="nearest")


def get_seeds(boundary: np.ndarray, next_id: int = 1):
    """Seeds of one slice (the regional maxima of the distance transform of
    boundary < 0.5, labelled) and their count; ids start at ``next_id``."""
    maxima = _regional_maxima(ndimage.distance_transform_edt(boundary < 0.5))
    seeds, num = ndimage.label(maxima)
    seeds = seeds.astype(np.int32)
    seeds[seeds > 0] += next_id - 1
    return seeds, num


def watershed_from_affs(affs: np.ndarray) -> np.ndarray:
    """Per-slice fragments (D, H, W) uint64 from 3-channel 3D affinities."""
    affs_xy = 1.0 - 0.5 * (affs[1] + affs[2])
    fragments = np.zeros(affs_xy.shape, dtype=np.uint64)
    next_id = 1
    for z in range(affs_xy.shape[0]):
        seeds, num = get_seeds(affs_xy[z], next_id=next_id)
        fragments[z] = seeded_watershed(affs_xy[z], seeds).astype(np.uint64)
        next_id += num
    return fragments


def distance_transform_watershed(hmap: np.ndarray):
    """2D distance-transform watershed: returns (labels, max_id)."""
    dt = ndimage.gaussian_filter(ndimage.distance_transform_edt(hmap < 0.25), 2.0)
    seeds, n = ndimage.label(_regional_maxima(dt))
    labels = seeded_watershed(hmap.astype(np.float32), seeds.astype(np.int32))
    return labels.astype(np.uint64), int(n)
