"""Host-side label utilities (numpy): relabelling, the 2D affinity targets
and class-balancing weights, and the border widening of the AC3/AC4
training labels, from the JAX package's ``ops/affinity_np.py``."""

from __future__ import annotations

import numpy as np


def relabel(seg: np.ndarray, do_type: bool = False) -> np.ndarray:
    """Relabel instances to consecutive ids 1..N (0 stays background)."""
    uid = np.unique(seg)
    if len(uid) == 1 and uid[0] == 0:
        return seg
    uid = uid[uid > 0]
    mid = int(uid.max()) + 1
    m_type = seg.dtype
    if do_type:
        if mid < 2 ** 8:
            m_type = np.uint8
        elif mid < 2 ** 16:
            m_type = np.uint16
        elif mid < 2 ** 32:
            m_type = np.uint32
        else:
            m_type = np.uint64
    mapping = np.zeros(mid, dtype=m_type)
    mapping[uid] = np.arange(1, len(uid) + 1, dtype=m_type)
    return mapping[seg]


def _neighbour(a: np.ndarray, off) -> tuple[np.ndarray, np.ndarray]:
    """(a[p + off], 1 where p + off lies inside) for a 2D array, the
    neighbour 0 outside."""
    h, w = a.shape
    oy, ox = int(off[0]), int(off[1])
    out = np.zeros_like(a)
    inside = np.zeros(a.shape, np.uint8)
    ys, xs = slice(max(0, -oy), min(h, h - oy)), slice(max(0, -ox), min(w, w - ox))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[ys, xs] = a[ys.start + oy:ys.stop + oy, xs.start + ox:xs.stop + ox]
        inside[ys, xs] = 1
    return out, inside


def gen_affs(labels: np.ndarray, offsets, ignore: bool = False, padding: bool = False):
    """(H, W) labels -> (affs float32 (K, H, W), masks uint8 (K, H, W)):
    1 where the labels at p and p + o_k agree (background with background
    too; with ``ignore`` 0 where either is background); where p + o_k lies
    outside the mask is 0 and the target ``padding``."""
    labels = np.asarray(labels)
    affs = np.zeros((len(offsets),) + labels.shape, np.float32)
    masks = np.zeros((len(offsets),) + labels.shape, np.uint8)
    for k, off in enumerate(offsets):
        shifted, inside = _neighbour(labels, off)
        out = (labels == shifted).astype(np.float32)
        if ignore:
            out[(labels == 0) | (shifted == 0)] = 0
        out[inside == 0] = 1.0 if padding else 0.0
        affs[k], masks[k] = out, inside
    return affs, masks


def weight_binary_ratio(label: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Inverse class-frequency weights of a binary target, the fraction
    taken in float64 and clipped to [0.05, 0.99]; a uniform target gets
    all ones."""
    if label.max() == label.min():
        return np.ones_like(label, dtype=np.float32)
    binary = (label != 0).astype(np.float64)
    frac = np.clip(float(binary.sum()) / binary.size, 5e-2, 0.99)
    if frac > 0.5:
        weight = binary + alpha * frac / (1.0 - frac) * (1.0 - binary)
    else:
        weight = alpha * (1.0 - frac) / frac * binary + (1.0 - binary)
    return weight.astype(np.float32)


def seg_widen_border(seg: np.ndarray, tsz_h: int = 1) -> np.ndarray:
    """Kisuk Lee's border widening: a pixel becomes 0 where its (2t + 1)^2
    window (mirrored at the edge, the edge not repeated) holds more than one
    positive id. Min/max filters per 2D plane; a 3D array is taken slice by
    slice along z."""
    from scipy.ndimage import maximum_filter, minimum_filter

    seg = np.ascontiguousarray(seg)
    size = 2 * tsz_h + 1

    def one(plane: np.ndarray) -> np.ndarray:
        p0 = maximum_filter(plane, size=size, mode="mirror")
        tmp = plane.copy()
        tmp[tmp == 0] = plane.max() + 1
        p1 = minimum_filter(tmp, size=size, mode="mirror")
        return plane * (p0 == p1)

    if seg.ndim == 3:
        out = np.empty_like(seg)
        for z in range(seg.shape[0]):
            out[z] = one(seg[z])
        return out
    return one(seg)
