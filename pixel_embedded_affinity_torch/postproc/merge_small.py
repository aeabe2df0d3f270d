"""Small-object cleanup after decoding.

* ``merge_small_object`` / ``merge_func``: absorb tiny instances into the
  dominant neighbour inside a window around their centroid (the reference
  CVPPP post-processing; the bbbc variant uses thresholds 5/25/50/100).
* ``remove_small_object``: drop connected components below ``min_size``
  from a binary mask.
* ``merge_small_segments``: merge segments of at most ``min_seg_size``
  into the neighbour sharing the longest boundary (union-find over the
  region adjacency graph).
"""

from __future__ import annotations

from collections import defaultdict

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


def merge_small_segments(seg: np.ndarray, min_seg_size: int) -> np.ndarray:
    """Merge segments <= min_seg_size into the neighbor sharing the longest
    boundary (union-find over the RAG)."""
    seg = np.ascontiguousarray(seg)
    sizes = np.bincount(seg.reshape(-1))

    # boundary-length RAG from 4/6-neighborhood pairs
    edge_len: dict[tuple[int, int], int] = defaultdict(int)
    for axis in range(seg.ndim):
        sl_a = [slice(None)] * seg.ndim
        sl_b = [slice(None)] * seg.ndim
        sl_a[axis] = slice(1, None)
        sl_b[axis] = slice(0, -1)
        a = seg[tuple(sl_a)].reshape(-1)
        b = seg[tuple(sl_b)].reshape(-1)
        diff = a != b
        pairs = np.stack([np.minimum(a[diff], b[diff]),
                          np.maximum(a[diff], b[diff])], axis=1)
        if len(pairs):
            uniq, counts = np.unique(pairs, axis=0, return_counts=True)
            for (u, v), c in zip(uniq, counts):
                edge_len[(int(u), int(v))] += int(c)

    neighbors: dict[int, dict[int, int]] = defaultdict(dict)
    for (u, v), c in edge_len.items():
        neighbors[u][v] = neighbors[u].get(v, 0) + c
        neighbors[v][u] = neighbors[v].get(u, 0) + c

    parent = np.arange(sizes.size, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for n_id in range(1, sizes.size):
        if sizes[n_id] == 0 or sizes[n_id] > min_seg_size:
            continue
        nbrs = neighbors.get(n_id, {})
        if not nbrs:
            continue
        target = max(nbrs.items(), key=lambda kv: kv[1])[0]
        parent[find(n_id)] = find(target)

    lut = np.array([find(i) for i in range(sizes.size)], dtype=seg.dtype)
    return lut[seg]
