"""BBBC039V1 nuclei metrics: aggregated Jaccard index (AJI), pixel F1 and
panoptic quality, the JAX package's ``metrics/bbbc.py``.

Both work on the contingency matrix of the two label images. AJI takes the
ground-truth instances in id order, each matched to its best-IoU
prediction not yet used, and adds the unused predictions' pixels to the
union; fast PQ pairs instances whose IoU exceeds ``match_iou`` (0.5 by
default, at which each instance has at most one partner; below 0.5 by
the maximum-IoU assignment). One change: AJI of a
ground truth against an empty prediction is 0.0, the value its formula
gives (no intersection), where the JAX function stops at an argmax of an
empty sequence (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import numpy as np


def _overlap_matrix(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """(G + 1, P + 1) pixel counts of each (gt id, pred id) pair."""
    gt = gt.reshape(-1).astype(np.int64)
    pred = pred.reshape(-1).astype(np.int64)
    ng, npr = int(gt.max()) + 1, int(pred.max()) + 1
    return np.bincount(gt * npr + pred, minlength=ng * npr).reshape(ng, npr)


def agg_jc_index(gt_ins: np.ndarray, pred: np.ndarray) -> float:
    """Aggregated Jaccard index of instance labels 1..G and 1..P."""
    o = _overlap_matrix(gt_ins, pred).astype(np.float64)
    n_gt, n_pred = o.shape[0] - 1, o.shape[1] - 1
    if n_gt == 0 or n_pred == 0:
        return 0.0
    gt_sizes, pred_sizes = o.sum(axis=1), o.sum(axis=0)
    used = np.zeros(n_pred + 1, dtype=bool)
    c = u = 0.0
    for i in range(1, n_gt + 1):
        inter = o[i, 1:].copy()
        union = gt_sizes[i] + pred_sizes[1:] - inter
        # a used prediction counts as no overlap: IoU 0 against the gt alone
        inter[used[1:]] = 0.0
        union[used[1:]] = gt_sizes[i]
        iou = np.where(union > 0, inter / union, 0.0)
        j = int(np.argmax(iou))
        c += inter[j]
        u += union[j]
        used[j + 1] = True
    u += pred_sizes[1:][~used[1:] & (pred_sizes[1:] > 0)].sum()
    return float(c / u) if u > 0 else 0.0


def pixel_f1(gt_ins: np.ndarray, pred_ins: np.ndarray) -> float:
    """F1 of the foregrounds."""
    gt, pr = gt_ins > 0, pred_ins > 0
    tp = float((gt & pr).sum())
    fp = float((~gt & pr).sum())
    fn = float((gt & ~pr).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Ids renumbered 1..N as int32, in increasing order or, with
    ``by_size``, from the largest instance down (ties in increasing id);
    an image without instances comes back as it is."""
    ids, counts = np.unique(pred, return_counts=True)
    keep = ids != 0
    ids, counts = ids[keep], counts[keep]
    if ids.size == 0:
        return pred
    rank = np.arange(1, ids.size + 1, dtype=np.int32)
    if by_size:
        rank[np.argsort(-counts, kind="stable")] = rank.copy()
    out = np.zeros(pred.shape, np.int32)
    fg = pred != 0
    out[fg] = rank[np.searchsorted(ids, pred[fg])]
    return out


def get_fast_pq(true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5):
    """Panoptic quality of contiguous instance labels (``remap_label`` them
    first): ``([dq, sq, pq], [paired_true, paired_pred, unpaired_true,
    unpaired_pred])``. Pairs are the IoU > ``match_iou`` overlaps, unique
    from 0.5 up; below it, the maximum-IoU assignment (Hungarian) pairs
    above ``match_iou``."""
    if match_iou < 0.0:
        raise ValueError(f"match_iou {match_iou} < 0")
    o = _overlap_matrix(true, pred).astype(np.float64)
    n_true, n_pred = o.shape[0] - 1, o.shape[1] - 1
    if n_true == 0 or n_pred == 0:
        tp, fp, fn = 0, n_pred, n_true
        dq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) else 0.0
        return [dq, 0.0, 0.0], [[], [], list(range(1, n_true + 1)),
                                list(range(1, n_pred + 1))]
    inter = o[1:, 1:]
    union = o.sum(axis=1)[1:, None] + o.sum(axis=0)[None, 1:] - inter
    iou = np.where(union > 0, inter / union, 0.0)
    if match_iou >= 0.5:
        masked = np.where(iou > match_iou, iou, 0.0)
        pt, pp = np.nonzero(masked)
        paired_iou = masked[pt, pp]
    else:
        from scipy.optimize import linear_sum_assignment

        pt, pp = linear_sum_assignment(-iou)
        keep = iou[pt, pp] > match_iou
        pt, pp = pt[keep], pp[keep]
        paired_iou = iou[pt, pp]
    paired_true, paired_pred = list(pt + 1), list(pp + 1)
    unpaired_true = sorted(set(range(1, n_true + 1)) - set(paired_true))
    unpaired_pred = sorted(set(range(1, n_pred + 1)) - set(paired_pred))
    tp, fp, fn = len(paired_true), len(unpaired_pred), len(unpaired_true)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn)
    sq = paired_iou.sum() / (tp + 1.0e-6)
    return [dq, sq, dq * sq], [paired_true, paired_pred, unpaired_true, unpaired_pred]
