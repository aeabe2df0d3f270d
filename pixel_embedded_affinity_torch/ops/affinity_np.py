"""Host-side label utilities (numpy): relabelling, the 2D and 3D affinity
targets, class-balancing weights, label pyramids, and the border widening
of the AC3/AC4 training labels, from the JAX package's
``ops/affinity_np.py``; also the targets and weights that no main path
uses (the mutex-style 3D targets, small-instance removal, instance
boundaries, the U-Net separation weights). The host samplers (:mod:`..data.cvppp`,
:mod:`..data.bbbc`, :mod:`..data.ac3ac4`) build their targets with these;
:mod:`.targets` builds the same on the device."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import maximum_filter, minimum_filter


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


def seg_to_aff_3d(seg: np.ndarray, nhood=((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
                  pad: str = "replicate") -> np.ndarray:
    """Affinities of a 2D or 3D segmentation, connectomics semantics:
    channel e at p is 1 where p and p + nhood[e] both lie inside, carry
    one id and are foreground; 0 where p + nhood[e] lies outside. With the
    unit neighbourhood and ``pad == "replicate"`` each axis's leading face
    takes the foreground mask."""
    seg = np.asarray(seg)
    nhood = np.asarray(nhood, dtype=np.int64)
    aff = np.zeros((nhood.shape[0],) + seg.shape, dtype=np.float32)
    for e in range(nhood.shape[0]):
        sl_a, sl_b = [], []
        for d in range(seg.ndim):
            o, n = int(nhood[e, d]), seg.shape[d]
            sl_a.append(slice(max(0, -o), min(n, n - o)))
            sl_b.append(slice(max(0, o), min(n, n + o)))
        a, b = seg[tuple(sl_a)], seg[tuple(sl_b)]
        aff[(e,) + tuple(sl_a)] = ((a == b) & (a > 0) & (b > 0)).astype(np.float32)
    if pad == "replicate" and nhood.shape[0] == seg.ndim:
        for e in range(nhood.shape[0]):
            face = [slice(None)] * seg.ndim
            face[e] = 0
            aff[(e,) + tuple(face)] = (seg[tuple(face)] > 0).astype(np.float32)
    return aff


# the 12-channel table, (z, y, x) interleaved per shift group
AFF_GROUPS_3D = (((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
                 ((-2, 0, 0), (0, -3, 0), (0, 0, -3)),
                 ((-3, 0, 0), (0, -9, 0), (0, 0, -9)),
                 ((-4, 0, 0), (0, -27, 0), (0, 0, -27)))


def seg_to_aff_3d_12ch(seg: np.ndarray) -> np.ndarray:
    """The 12-channel targets of a (D, H, W) volume, every group without
    the leading-face fill."""
    return np.concatenate([seg_to_aff_3d(seg, g, pad="") for g in AFF_GROUPS_3D], axis=0)


def weight_binary_ratio(label: np.ndarray, mask: np.ndarray | None = None,
                        alpha: float = 1.0) -> np.ndarray:
    """Inverse class-frequency weights of a binary target, the fraction
    taken in float64 (over ``mask``'s pixels when given, the weights then
    multiplied by it) and clipped to [0.05, 0.99]; a uniform target gets
    all ones."""
    if label.max() == label.min():
        return np.ones_like(label, dtype=np.float32)
    binary = (label != 0).astype(np.float64)
    if mask is None:
        frac = float(binary.sum()) / binary.size
    else:
        frac = float((binary * mask).sum()) / float(mask.sum())
    frac = np.clip(frac, 5e-2, 0.99)
    if frac > 0.5:
        weight = binary + alpha * frac / (1.0 - frac) * (1.0 - binary)
    else:
        weight = alpha * (1.0 - frac) / frac * binary + (1.0 - binary)
    if mask is not None:
        weight = weight * mask
    return weight.astype(np.float32)


def label_pyramid(label: np.ndarray, num_levels: int = 4) -> list:
    """Nearest-neighbour label levels /2 .. /2^num_levels (a (D, H, W)
    volume in y and x only), as ``cv2.resize(fx=fy=2^-k, INTER_NEAREST)``
    makes them: the side round(n 2^-k), half to even, and the source index
    floor(d 2^k)."""
    out = []
    for k in range(1, num_levels + 1):
        s = 2 ** k
        h, w = label.shape[-2:]
        oh, ow = int(np.rint(h / s)), int(np.rint(w / s))
        out.append(np.ascontiguousarray(label[..., ::s, ::s][..., :oh, :ow]))
    return out


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


def gen_affs_mutex_3d(labels: np.ndarray, offsets, padding: bool = True,
                      background: bool = False) -> np.ndarray:
    """Mutex-style GT for arbitrary 3D offsets (gen_affs_mutex_3d parity).

    Channel c at voxel p (both p and p+offsets[c] in bounds): 1 iff
    labels[p] == labels[p+o] (and both > 0 unless ``background``).
    Out-of-bounds region: foreground mask if ``padding`` else 0.
    """
    labels = np.asarray(labels)
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.shape[0]
    affs = np.zeros((n,) + labels.shape, dtype=np.float32)
    fg = (labels > 0).astype(np.float32)
    for c in range(n):
        sl_a, sl_b = [], []
        for d in range(3):
            o = int(offsets[c, d])
            size = labels.shape[d]
            sl_a.append(slice(max(0, -o), min(size, size - o)))
            sl_b.append(slice(max(0, o), min(size, size + o)))
        a = labels[tuple(sl_a)]
        b = labels[tuple(sl_b)]
        eq = (a == b).astype(np.float32)
        if not background:
            eq = eq * (a > 0) * (b > 0)
        if padding:
            affs[c] = fg
        affs[(c,) + tuple(sl_a)] = eq
    return affs


def remove_small(seg: np.ndarray, thres: int = 100) -> np.ndarray:
    """Zero out instances smaller than ``thres`` pixels (in-place semantics)."""
    sz = seg.shape
    seg = seg.reshape(-1)
    uid, uc = np.unique(seg, return_counts=True)
    seg[np.isin(seg, uid[uc < thres])] = 0
    return seg.reshape(sz)


def seg_to_instance_bd(seg: np.ndarray, tsz_h: int = 7,
                       do_bg: bool = False) -> np.ndarray:
    """Instance-boundary mask via windowed label min/max.

    Parity with the reference's im2col form (scripts_cvppp/data/
    data_segmentation.py:105-122): a pixel is boundary when its
    (2*tsz_h+1)^2 mirror-padded window contains two different labels —
    with ``do_bg`` counting background as a side, otherwise only between
    two non-zero instances (zeros are excluded from the min).
    Accepts (D, H, W) or (H, W)."""
    seg3 = seg[None] if seg.ndim == 2 else seg
    size = 2 * tsz_h + 1
    mm = int(seg3.max())
    bd = np.zeros(seg3.shape, np.uint8)
    for z in range(seg3.shape[0]):
        plane = seg3[z]
        p0 = maximum_filter(plane, size=size, mode="mirror")
        if do_bg:
            p1 = minimum_filter(plane, size=size, mode="mirror")
            bd[z] = ((p0 > 0) & (p0 != p1)).astype(np.uint8)
        else:
            nz = np.where(plane == 0, mm + 1, plane)
            p1 = minimum_filter(nz, size=size, mode="mirror")
            bd[z] = ((p0 != 0) & (p1 != 0) & (p0 != p1)).astype(np.uint8)
    return bd[0] if seg.ndim == 2 else bd


def _inner_boundaries(mask: np.ndarray) -> np.ndarray:
    """skimage.segmentation.find_boundaries(mode='inner') semantics for a
    binary mask: object pixels with a 4-connected non-object neighbor
    (image border does NOT count as outside)."""
    m = mask.astype(bool)
    out = np.zeros_like(m)
    for axis in (0, 1):
        for d in (1, -1):
            nb = np.ones_like(m)
            src = [slice(None)] * 2
            dst = [slice(None)] * 2
            src[axis] = slice(1, None) if d == 1 else slice(None, -1)
            dst[axis] = slice(None, -1) if d == 1 else slice(1, None)
            nb[tuple(dst)] = m[tuple(src)]
            out |= m & ~nb
    return out


def weight_unet2d(seg: np.ndarray, w0: float = 10.0,
                  sigma: float = 5.0) -> np.ndarray:
    """U-Net paper separation weight map for a multi-instance label plane.

    Parity with data_segmentation.py:237-283: per pixel, the two smallest
    distances d1 <= d2 to INSTANCE BOUNDARIES (inner boundaries of each
    instance); weight = w0 * exp(-(d1+d2)^2 / (2 sigma^2)) (d1 only when
    a single instance exists), plus the inverse class-frequency weight.
    Distances computed by per-instance EDT instead of the reference's
    brute-force pairwise loop (identical values, O(n) not O(n*m))."""
    from scipy.ndimage import distance_transform_edt

    seg_ids = np.unique(seg)
    seg_ids = seg_ids[seg_ids > 0]
    h, w = seg.shape
    d1 = np.full((h, w), float(h + w), np.float64)
    d2 = np.full((h, w), float(h + w), np.float64)
    for sid in seg_ids:
        bounds = _inner_boundaries(seg == sid)
        if not bounds.any():
            continue
        dist = distance_transform_edt(~bounds)
        m1 = dist < d1
        d2[m1] = d1[m1]
        d1[m1] = dist[m1]
        m2 = (dist > d1) & (dist < d2) & ~m1
        d2[m2] = dist[m2]
    if len(seg_ids) == 1:
        loss_map = w0 * np.exp(-(d1 ** 2) / (2 * sigma ** 2))
    else:
        loss_map = w0 * np.exp(-((d1 + d2) ** 2) / (2 * sigma ** 2))
    wc_1 = float((seg == 0).mean())
    loss_map = loss_map.copy()
    loss_map[seg > 0] += wc_1
    loss_map[seg == 0] += 1.0 - wc_1
    return loss_map


def weight_unet3d(seg: np.ndarray, w0: float = 10.0,
                  sigma: float = 5.0) -> np.ndarray:
    """Per-slice U-Net weight map over non-empty z slices
    (data_segmentation.py:230-235).

    Deliberate deviation: returns float64 weights. The reference's
    np.zeros_like(seg) truncates each slice's weights to seg's integer
    dtype (a reference bug); that truncation is intentionally NOT
    reproduced here."""
    out = np.zeros(seg.shape, np.float64)
    zid = np.where((seg > 0).max(axis=(1, 2)))[0]
    for z in zid:
        out[z] = weight_unet2d(seg[z], w0, sigma)
    return out
