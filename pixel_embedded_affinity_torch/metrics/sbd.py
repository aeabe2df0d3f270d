"""SBD / DiC metrics (CVPPP), contingency-table implementation.

BestDice loops every label value in (min, max] of each image (consecutive
ids assumed; missing ids score 0), Dice(i, j) = 2|i∩j| / (|i| + |j|). One
pass builds the overlap matrix, so each Dice is an O(1) lookup.
"""

from __future__ import annotations

import numpy as np


def _contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Overlap counts between label images (dense, small label ranges)."""
    a = a.reshape(-1).astype(np.int64)
    b = b.reshape(-1).astype(np.int64)
    na = int(a.max()) + 1
    nb = int(b.max()) + 1
    return np.bincount(a * nb + b, minlength=na * nb).reshape(na, nb)


def best_dice(in_label: np.ndarray, gt_label: np.ndarray) -> float:
    max_in, min_in = int(in_label.max()), int(in_label.min())
    max_gt, min_gt = int(gt_label.max()), int(gt_label.min())
    if max_in == min_in:
        return 0.0
    o = _contingency(in_label, gt_label).astype(np.float64)
    sizes_in = o.sum(axis=1)
    sizes_gt = o.sum(axis=0)
    score = 0.0
    for i in range(min_in + 1, max_in + 1):
        s_max = 0.0
        si = sizes_in[i] if i < len(sizes_in) else 0.0
        for j in range(min_gt + 1, max_gt + 1):
            sj = sizes_gt[j] if j < len(sizes_gt) else 0.0
            ov = o[i, j] if i < o.shape[0] and j < o.shape[1] else 0.0
            denom = si + sj
            s = 2.0 * ov / denom if denom > 1e-8 else 0.0
            if s > s_max:
                s_max = s
        score += s_max
    return score / (max_in - min_in)


def symmetric_best_dice(in_label, gt_label) -> float:
    """min(BD(in, gt), BD(gt, in)) — the CVPPP SBD."""
    return min(best_dice(in_label, gt_label), best_dice(gt_label, in_label))


def diff_fg_labels(in_label, gt_label) -> float:
    return float((int(in_label.max()) - int(in_label.min()))
                 - (int(gt_label.max()) - int(gt_label.min())))


def abs_diff_fg_labels(in_label, gt_label) -> float:
    return abs(diff_fg_labels(in_label, gt_label))
