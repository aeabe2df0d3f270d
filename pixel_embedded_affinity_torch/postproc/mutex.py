"""Mutex watershed decoding (native C++, elf/affogato semantics).

``seg_mutex`` takes affinities: the first ndim channels (the unit offsets)
are attractive edges with weight = affinity, the rest repulsive with weight
= 1 - affinity, subsampled by ``strides``.
"""

from __future__ import annotations

import numpy as np

from ._native import get_lib


def mws_segmentation(weights: np.ndarray, offsets, n_attractive: int,
                     strides=None, randomize_strides: bool = False,
                     seed: int = 0, mask: np.ndarray | None = None) -> np.ndarray:
    """Raw mutex watershed. weights: (C, *spatial) edge priorities."""
    lib = get_lib()
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    c = weights.shape[0]
    dims = np.asarray(weights.shape[1:], dtype=np.int64)
    ndim = len(dims)
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32))
    if offs.shape != (c, ndim):
        raise ValueError(f"offsets {offs.shape} do not match {c} channels of {ndim}-D")
    if strides is None:
        strides = [1] * ndim
    strides = np.ascontiguousarray(np.asarray(strides, dtype=np.int32))
    out = np.zeros(int(np.prod(dims)), dtype=np.uint32)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask.reshape(-1).astype(np.uint8))
        mask_ptr = mask.ctypes.data
    n_seg = lib.mws_segmentation(
        weights.reshape(c, -1), offs, c, int(n_attractive), dims, ndim,
        strides, int(randomize_strides), int(seed), mask_ptr, out)
    if n_seg < 0:
        raise ValueError("volume too large for 32-bit edge ids")
    return out.reshape(tuple(dims))


def seg_mutex(affs: np.ndarray, offsets=((-1, 0), (0, -1)), strides=(1, 1),
              randomize_strides: bool = False, mask: np.ndarray | None = None,
              seed: int = 0) -> np.ndarray:
    """Mutex watershed on AFFINITIES, as elf's mutex_watershed(1 - affs,
    offsets, strides, mask) is called by the reference."""
    affs = np.asarray(affs, dtype=np.float32)
    ndim = affs.ndim - 1
    weights = 1.0 - affs
    weights[:ndim] = affs[:ndim]
    return mws_segmentation(weights, offsets, n_attractive=ndim,
                            strides=strides,
                            randomize_strides=randomize_strides,
                            seed=seed, mask=mask)
