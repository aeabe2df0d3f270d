"""Hierarchical mean-affinity agglomeration (waterz's semantics), the JAX
package's ``postproc/agglomerate.py``: fragments are merged while
1 - mean affinity across their boundary is below the threshold, with
waterz's 256-level discretised merge queue."""

from __future__ import annotations

import numpy as np

from ._native import get_lib

_MEAN_SCORING = 0
_QUEUE_LEVELS = 256


def agglomerate(affs: np.ndarray, fragments: np.ndarray,
                threshold: float = 0.5) -> np.ndarray:
    """affs (3, D, H, W) float; fragments (D, H, W) uint64 -> merged labels."""
    lib = get_lib()
    affs = np.ascontiguousarray(affs, dtype=np.float32)
    fragments = np.ascontiguousarray(fragments, dtype=np.uint64)
    d, h, w = fragments.shape
    out = np.zeros(fragments.size, dtype=np.uint64)
    lib.agglomerate_scored(affs.reshape(3, -1), fragments.reshape(-1), d, h, w,
                           float(threshold), _MEAN_SCORING, _QUEUE_LEVELS, out)
    return out.reshape(d, h, w)
