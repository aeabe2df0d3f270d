"""Variation of information and adapted Rand error (skimage semantics).

Pixels whose TRUE label is in ``ignore_labels`` are dropped from the
contingency table, as skimage's ``ignore_labels=(0,)`` does.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def _contingency_norm(im_true, im_test, ignore_labels=(0,)):
    t = im_true.reshape(-1).astype(np.int64)
    p = im_test.reshape(-1).astype(np.int64)
    data = np.ones(t.size, dtype=np.float64)
    for lab in ignore_labels:
        data[t == lab] = 0.0
    cont = sparse.coo_matrix((data, (t, p))).tocsr()
    total = cont.sum()
    if total == 0:
        return cont
    return cont / total


def voi(im_true, im_test, ignore_labels=(0,)):
    """Returns (voi_split, voi_merge) = (H(test|true), H(true|test))."""
    cont = _contingency_norm(im_true, im_test, ignore_labels)
    pxy = cont.tocoo()
    px = np.asarray(cont.sum(axis=1)).reshape(-1)
    py = np.asarray(cont.sum(axis=0)).reshape(-1)
    vals = pxy.data
    nz = vals > 0
    vals = vals[nz]
    rows = pxy.row[nz]
    cols = pxy.col[nz]
    h_test_given_true = -np.sum(vals * (np.log(vals) - np.log(px[rows])))
    h_true_given_test = -np.sum(vals * (np.log(vals) - np.log(py[cols])))
    return float(h_test_given_true), float(h_true_given_test)


def adapted_rand_error(im_true, im_test, ignore_labels=(0,)):
    """Returns (are, precision, recall); are = 1 - F1 of pair classification."""
    cont = _contingency_norm(im_true, im_test, ignore_labels)
    pxy = cont.tocoo()
    sum_p2 = float(np.sum(pxy.data ** 2))
    a = np.asarray(cont.sum(axis=1)).reshape(-1)
    b = np.asarray(cont.sum(axis=0)).reshape(-1)
    sum_a2 = float(np.sum(a ** 2))
    sum_b2 = float(np.sum(b ** 2))
    precision = sum_p2 / sum_b2 if sum_b2 > 0 else 0.0
    recall = sum_p2 / sum_a2 if sum_a2 > 0 else 0.0
    if precision + recall == 0:
        return 1.0, 0.0, 0.0
    fscore = 2.0 * precision * recall / (precision + recall)
    return 1.0 - fscore, precision, recall
