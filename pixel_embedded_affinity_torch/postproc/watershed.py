"""Watershed fragments (scipy + the native library), the JAX package's
``postproc/watershed.py``.

* ``watershed_from_affs`` (scripts_ac3ac4/utils/fragment.py:15-27): per-slice
  seeded watershed on boundary = 1 - 0.5 * (affs_y + affs_x), seeds from
  ``get_seeds``: 'maxima_distance' (the regional maxima of the distance
  transform of boundary < 0.5, the decoders' default), 'minima' or a
  regular 'grid'.
* ``distance_transform_watershed`` (elf's, the multicut baseline's
  fragments, scripts_ac3ac4/utils/lmc.py:13): Gaussian-smoothed distance
  transform of (hmap < threshold), seeds = connected regional maxima,
  watershed on hmap.
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


def get_seeds(boundary: np.ndarray, method: str = "grid", next_id: int = 1,
              seed_distance: int = 10):
    """Seeds of one slice and their count, ids from ``next_id``
    (fragment.py:29-53): a grid every ``seed_distance`` pixels, the
    labelled regional minima of ``boundary`` ('minima'), or the labelled
    regional maxima of the distance transform of boundary < 0.5
    ('maxima_distance')."""
    if method == "grid":
        h, w = boundary.shape
        ys = np.arange(0, h, seed_distance)
        xs = np.arange(0, w, seed_distance)
        num = len(ys) * len(xs)
        seeds = np.zeros_like(boundary, dtype=np.int32)
        seeds[np.ix_(ys, xs)] = np.arange(next_id, next_id + num).reshape(len(ys), len(xs))
        return seeds, num
    if method == "minima":
        maxima = _regional_maxima(-boundary)
    elif method == "maxima_distance":
        maxima = _regional_maxima(ndimage.distance_transform_edt(boundary < 0.5))
    else:
        raise ValueError(f"unknown seed method {method}")
    seeds, num = ndimage.label(maxima)
    seeds = seeds.astype(np.int32)
    seeds[seeds > 0] += next_id - 1
    return seeds, num


def watershed_from_affs(affs: np.ndarray, seed_method: str = "maxima_distance",
                        seed_distance: int = 10) -> np.ndarray:
    """Per-slice fragments (D, H, W) uint64 from 3-channel 3D affinities."""
    affs_xy = 1.0 - 0.5 * (affs[1] + affs[2])
    fragments = np.zeros(affs_xy.shape, dtype=np.uint64)
    next_id = 1
    for z in range(affs_xy.shape[0]):
        seeds, num = get_seeds(affs_xy[z], method=seed_method, next_id=next_id,
                               seed_distance=seed_distance)
        fragments[z] = seeded_watershed(affs_xy[z], seeds).astype(np.uint64)
        next_id += num
    return fragments


def distance_transform_watershed(hmap: np.ndarray, threshold: float = 0.25,
                                 sigma_seeds: float = 2.0):
    """2D distance-transform watershed: returns (labels, max_id)."""
    dt = ndimage.distance_transform_edt(hmap < threshold)
    if sigma_seeds > 0:
        dt = ndimage.gaussian_filter(dt, sigma_seeds)
    seeds, n = ndimage.label(_regional_maxima(dt))
    labels = seeded_watershed(hmap.astype(np.float32), seeds.astype(np.int32))
    return labels.astype(np.uint64), int(n)
