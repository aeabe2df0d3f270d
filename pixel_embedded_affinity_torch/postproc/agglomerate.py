"""Hierarchical agglomeration (waterz's semantics), the JAX package's
``postproc/agglomerate.py``: fragments are merged while the boundary's
score (1 - mean affinity by default) is below the threshold, with waterz's
256-level discretised merge queue. ``seg_waterz`` is the whole waterz path:
per-slice seeded watershed fragments, then agglomeration
(scripts_ac3ac4/main.py:316-321, scripts_cvppp/utils/seg_waterz.py:66-84)."""

from __future__ import annotations

import numpy as np

from ._native import get_lib
from .watershed import watershed_from_affs

# waterz's scoring functions: OneMinus<MeanAffinity> and the
# HistogramQuantileProvider family (256-bin histograms)
SCORING_MODES = {"mean": 0, "quantile50": 1, "median": 1, "quantile25": 2,
                 "quantile75": 3, "quantile15": 4, "quantile85": 5,
                 "max": 6, "min": 7}


def agglomerate(affs: np.ndarray, fragments: np.ndarray, threshold: float = 0.5,
                scoring: str = "mean", discretize_queue: int = 256) -> np.ndarray:
    """affs (3, D, H, W) float; fragments (D, H, W) uint64 -> merged labels.
    ``discretize_queue`` 256 is waterz's merge order (256 score levels, FIFO
    within a level), 0 an exact priority queue."""
    lib = get_lib()
    affs = np.ascontiguousarray(affs, dtype=np.float32)
    fragments = np.ascontiguousarray(fragments, dtype=np.uint64)
    d, h, w = fragments.shape
    out = np.zeros(fragments.size, dtype=np.uint64)
    lib.agglomerate_scored(affs.reshape(3, -1), fragments.reshape(-1), d, h, w,
                           float(threshold), SCORING_MODES[scoring], int(discretize_queue), out)
    return out.reshape(d, h, w)


def agglomerate_multi(affs: np.ndarray, fragments: np.ndarray, thresholds) -> list:
    """One segmentation per threshold, ascending, each continuing to merge
    the previous one (waterz.agglomerate's several thresholds)."""
    out = []
    frags = fragments
    for t in sorted(thresholds):
        frags = agglomerate(affs, frags, threshold=float(t))
        out.append(frags.copy())
    return out


def seg_waterz(affs: np.ndarray, threshold: float = 0.5,
               seed_method: str = "maxima_distance") -> np.ndarray:
    """The waterz path on 3-channel 3D affinities. 2D affinities (K >= 2,
    H, W) are lifted to one slice, the first two channels as y and x, as
    the reference's 2D wrapper does; the result is squeezed."""
    affs = np.asarray(affs, dtype=np.float32)
    if affs.ndim == 3:  # (K, H, W) -> (3, 1, H, W)
        a3 = np.zeros((3, 1) + affs.shape[1:], dtype=np.float32)
        a3[1, 0] = affs[0]
        a3[2, 0] = affs[1]
        affs = a3
    fragments = watershed_from_affs(affs, seed_method=seed_method)
    return np.squeeze(agglomerate(affs, fragments, threshold=threshold))
