"""Small-object cleanup after decoding.

* ``merge_small_object`` / ``merge_func``: absorb tiny instances into the
  dominant neighbour inside a window around their centroid (the reference
  CVPPP post-processing; the bbbc variant uses thresholds 5/25/50/100).
* ``remove_small_object``: drop connected components below ``min_size``
  from a binary mask.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def merge_small_object(seg: np.ndarray, threshold: int = 5,
                       window: int = 5) -> np.ndarray:
    """Merge instances of <= ``threshold`` pixels, in place. Keeps the
    reference's raw-slice quirk: a centroid within window//2 of the
    top/left border gives a negative slice start, which numpy resolves as a
    wrapped (usually empty) crop, so the merge is skipped there."""
    uid, uc = np.unique(seg, return_counts=True)
    for ids, size in zip(uid, uc):
        if size > threshold:
            continue
        pos = np.where(seg == ids)
        if len(pos[0]) == 0:
            continue
        pos_x = int(pos[0].sum() // pos[0].size) - window // 2
        pos_y = int(pos[1].sum() // pos[1].size) - window // 2
        crop = seg[pos_x:pos_x + window, pos_y:pos_y + window]
        t_uid, t_uc = np.unique(crop, return_counts=True)
        rank = np.argsort(-t_uc)
        if len(t_uc) > 2:
            if t_uid[rank[0]] == 0:
                if t_uid[rank[1]] == ids:
                    max_ids = t_uid[rank[2]]
                else:
                    max_ids = t_uid[rank[1]]
            else:
                max_ids = t_uid[rank[0]]
            seg[seg == ids] = max_ids
    return seg


def merge_func(seg: np.ndarray, variant: str = "cvppp") -> np.ndarray:
    if variant == "bbbc":
        schedule = [(5, 5), (25, 11), (50, 11), (100, 21)]
    else:
        schedule = [(5, 5), (20, 11), (50, 11), (300, 21)]
    for threshold, window in schedule:
        seg = merge_small_object(seg, threshold=threshold, window=window)
    return seg


def remove_small_object(mask: np.ndarray, min_size: int = 25) -> np.ndarray:
    """Binary-mask cleanup: drop connected components below min_size."""
    lab, n = ndimage.label(mask > 0)
    if n == 0:
        return np.zeros_like(mask)
    sizes = np.bincount(lab.reshape(-1))
    keep = sizes >= min_size
    keep[0] = False
    return keep[lab].astype(mask.dtype)
