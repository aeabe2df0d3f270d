"""Superpixel multicut baselines (the JAX package's
``postproc/mc_baselines.py``; the reference's mc_baselines.py:108-301):
plain multicut over distance-transform watershed superpixels, the
long-range multicut (extra contractible cost edges from long-range
affinities) and the lifted multicut (long-range edges in the objective,
never contracted), and pseudo-label generation by mutex watershed."""

from __future__ import annotations

import numpy as np

from .multicut import (compact_ids, fragments_from_boundary, labels_to_fragments,
                       lifted_multicut_gaec, multicut_gaec, rag_mean_affinity,
                       transform_probabilities_to_costs)

LONG_RANGE_OFFSETS = ((-2, 0, 0), (0, -9, 0), (0, 0, -9))


def _long_range_edges(fragments: np.ndarray, inv_affs: np.ndarray, offsets):
    """(uv, mean boundary-ness, count) of the fragment pairs that the
    long-range offsets join, pairs as (min, max) in first-seen order, as the
    JAX package accumulates them."""
    stats: dict = {}
    dims = fragments.shape
    for c, off in enumerate(offsets):
        sl_a, sl_b = [], []
        for d in range(3):
            o, n = int(off[d]), dims[d]
            sl_a.append(slice(max(0, -o), min(n, n - o)))
            sl_b.append(slice(max(0, o), min(n, n + o)))
        a = fragments[tuple(sl_a)].reshape(-1)
        b = fragments[tuple(sl_b)].reshape(-1)
        v = inv_affs[(c,) + tuple(sl_a)].reshape(-1)
        diff = a != b
        for u, w, val in zip(a[diff], b[diff], v[diff]):
            s = stats.setdefault((min(int(u), int(w)), max(int(u), int(w))), [0.0, 0.0])
            s[0] += val
            s[1] += 1
    uv = np.array(list(stats.keys()), np.uint64).reshape(-1, 2)
    mean = np.array([s[0] / s[1] for s in stats.values()])
    size = np.array([s[1] for s in stats.values()])
    return uv, mean, size


def _local_graph(affs_local: np.ndarray):
    inv = 1.0 - np.asarray(affs_local, np.float32)
    fragments = fragments_from_boundary(np.maximum(inv[1], inv[2]))
    uv, mean, size = rag_mean_affinity(fragments, inv[:3])
    return fragments, uv, transform_probabilities_to_costs(mean, edge_sizes=size)


def _long_costs(fragments, affs_long, offsets):
    uv, mean, size = _long_range_edges(fragments, 1.0 - np.asarray(affs_long, np.float32),
                                       offsets)
    return uv, transform_probabilities_to_costs(mean, edge_sizes=size)


class McSuperpixel:
    """Plain multicut over distance-transform watershed superpixels."""

    def __call__(self, affs: np.ndarray) -> np.ndarray:
        fragments, uv, costs = _local_graph(affs)
        uniq, uv_c = compact_ids(fragments, uv)
        return labels_to_fragments(fragments, uniq, multicut_gaec(len(uniq), uv_c, costs))


class LongRangeMulticutSuperpixel:
    """Multicut with extra long-range cost edges, all contractible."""

    def __init__(self, offsets=LONG_RANGE_OFFSETS):
        self.offsets = offsets

    def __call__(self, affs_local: np.ndarray, affs_long: np.ndarray | None = None):
        fragments, uv, costs = _local_graph(affs_local)
        if affs_long is not None:
            uv2, costs2 = _long_costs(fragments, affs_long, self.offsets)
            uv = np.concatenate([uv, uv2], axis=0)
            costs = np.concatenate([costs, costs2])
        uniq, uv_c = compact_ids(fragments, uv)
        return labels_to_fragments(fragments, uniq, multicut_gaec(len(uniq), uv_c, costs))


class LmcSuperpixel:
    """Lifted multicut over superpixels: the long-range affinities' edges
    enter the objective as lifted edges, never contracted."""

    def __init__(self, offsets=LONG_RANGE_OFFSETS):
        self.offsets = offsets

    def __call__(self, affs_local: np.ndarray, affs_long: np.ndarray | None = None):
        fragments, uv, costs = _local_graph(affs_local)
        uniq, uv_c = compact_ids(fragments, uv)
        if affs_long is not None:
            uv2, costs2 = _long_costs(fragments, affs_long, self.offsets)
            uv2c = compact_ids(fragments, uv2)[1]
        else:
            uv2c, costs2 = np.zeros((0, 2), np.uint64), np.zeros((0,), np.float64)
        labels = lifted_multicut_gaec(len(uniq), uv_c, costs, uv2c, costs2)
        return labels_to_fragments(fragments, uniq, labels)


def gen_pseudo_labels(affs: np.ndarray, offsets, strides=(1, 10, 10),
                      min_size: int = 100) -> np.ndarray:
    """Pseudo labels (the reference's utils/gen_pseudo.py role): the mutex
    watershed of the affinities, segments under ``min_size`` voxels zeroed,
    relabelled."""
    from ..ops.affinity_np import relabel, remove_small
    from .mutex import seg_mutex

    seg = seg_mutex(affs, offsets=offsets, strides=list(strides))
    return relabel(remove_small(seg.astype(np.int64), thres=min_size))
