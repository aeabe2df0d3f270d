"""Visualization: random-colour label maps, embedding PCA and SLIC, and
the training and validation montages (the JAX package's ``utils/show.py``,
the reference's utils/show.py), numpy and cv2 only: PNG artifacts for
checks by eye. The 2D trainer writes :func:`val_show` of the first
validation image at every validation.
"""

from __future__ import annotations

import os

import numpy as np


def draw_fragments_2d(seg: np.ndarray, seed: int = 123) -> np.ndarray:
    """Instance labels -> random-color RGB uint8 (background black)."""
    rng = np.random.default_rng(seed)
    ids = np.unique(seg)
    lut = np.zeros((int(ids.max()) + 1 if len(ids) else 1, 3), np.uint8)
    for i in ids:
        if i == 0:
            continue
        lut[i] = rng.integers(32, 255, 3)
    return lut[seg]


def draw_fragments_3d(seg: np.ndarray, seed: int = 123) -> np.ndarray:
    return np.stack([draw_fragments_2d(seg[z], seed) for z in range(seg.shape[0])])


def embedding_pca(embedding_hwc: np.ndarray) -> np.ndarray:
    """Project an (H, W, C) embedding to RGB via PCA (top-3 components)."""
    h, w, c = embedding_hwc.shape
    flat = embedding_hwc.reshape(-1, c).astype(np.float64)
    flat = flat - flat.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-8)
    return (proj.reshape(h, w, 3) * 255).astype(np.uint8)


def embedding_slic(embedding_hwc: np.ndarray, n_segments: int = 100,
                   compactness: float = 10.0, n_iter: int = 10,
                   run_pca: bool = True) -> np.ndarray:
    """SLIC superpixels over the (PCA-RGB) embedding — the reference's
    scripts_ac3ac4/utils/embeddings.py:35-46 viz utility (there via
    skimage.segmentation.slic; the port needs no skimage, so this is a
    small SLIC of its own: k-means in scaled (color, x, y) space with
    local window assignment, plus a connectivity sweep). Returns (H, W)
    int32 labels starting at 1, like skimage's."""
    emb = np.asarray(embedding_hwc)
    color = (embedding_pca(emb).astype(np.float64)
             if run_pca or emb.shape[-1] != 3 else emb.astype(np.float64))
    h, w, _ = color.shape
    s = max(int(np.sqrt(h * w / n_segments)), 1)
    # scale so color distances and spatial distances are comparable
    # (skimage convention: spatial term weighted compactness/S)
    ratio = compactness / s
    gy = np.arange(s // 2, h, s)
    gx = np.arange(s // 2, w, s)
    centers = np.array([[y, x] for y in gy for x in gx], np.float64)
    feat = np.concatenate(
        [color, np.mgrid[0:h, 0:w].transpose(1, 2, 0) * ratio], axis=-1)
    cfeat = np.array([feat[int(y), int(x)] for y, x in centers])
    labels = np.zeros((h, w), np.int64)
    dist = np.full((h, w), np.inf)
    for _ in range(n_iter):
        dist[:] = np.inf
        for k, (cy, cx) in enumerate(centers):
            y0, y1 = max(int(cy) - 2 * s, 0), min(int(cy) + 2 * s + 1, h)
            x0, x1 = max(int(cx) - 2 * s, 0), min(int(cx) + 2 * s + 1, w)
            d = ((feat[y0:y1, x0:x1] - cfeat[k]) ** 2).sum(-1)
            m = d < dist[y0:y1, x0:x1]
            dist[y0:y1, x0:x1][m] = d[m]
            labels[y0:y1, x0:x1][m] = k
        for k in range(len(centers)):
            sel = labels == k
            if sel.any():
                cfeat[k] = feat[sel].mean(axis=0)
                yy, xx = np.nonzero(sel)
                centers[k] = (yy.mean(), xx.mean())
    # connectivity: small stray components absorb into a neighbor label
    # (flood fill; no scipy/skimage dependency)
    out = _enforce_connectivity(labels)
    return (out + 1).astype(np.int32)


def _enforce_connectivity(labels: np.ndarray) -> np.ndarray:
    """Relabel connected components, then merge any component smaller than
    a quarter of the mean size into its most frequent neighbor label."""
    h, w = labels.shape
    comp = -np.ones((h, w), np.int64)
    sizes = []
    parent_label = []
    nxt = 0
    for y in range(h):
        for x in range(w):
            if comp[y, x] != -1:
                continue
            stack = [(y, x)]
            comp[y, x] = nxt
            lab = labels[y, x]
            n = 0
            while stack:
                cy, cx = stack.pop()
                n += 1
                for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ny, nx_ = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx_ < w and comp[ny, nx_] == -1 \
                            and labels[ny, nx_] == lab:
                        comp[ny, nx_] = nxt
                        stack.append((ny, nx_))
            sizes.append(n)
            parent_label.append(lab)
            nxt += 1
    sizes = np.asarray(sizes)
    min_size = max(int(sizes.mean() / 4), 1)
    out = comp.copy()
    for c in np.nonzero(sizes < min_size)[0]:
        sel = out == c
        # most frequent neighboring component
        neigh = []
        yy, xx = np.nonzero(sel)
        for cy, cx in zip(yy, xx):
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ny, nx_ = cy + dy, cx + dx
                if 0 <= ny < h and 0 <= nx_ < w and not sel[ny, nx_]:
                    neigh.append(out[ny, nx_])
        if neigh:
            vals, cnt = np.unique(neigh, return_counts=True)
            out[sel] = vals[np.argmax(cnt)]
    _, out = np.unique(out, return_inverse=True)
    return out.reshape(h, w)


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)


def val_show(iters: int, pred_aff: np.ndarray, gt_aff: np.ndarray,
             pred_seg: np.ndarray, gt_seg: np.ndarray, out_dir: str):
    """Side-by-side affinity/segmentation montage PNG."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    row1 = np.concatenate([_to_u8(pred_aff), _to_u8(gt_aff)], axis=1)
    row1 = np.repeat(row1[..., None], 3, axis=-1)
    row2 = np.concatenate([draw_fragments_2d(pred_seg),
                           draw_fragments_2d(gt_seg)], axis=1)
    h = min(row1.shape[1], row2.shape[1])
    montage = np.concatenate([row1[:, :h], row2[:, :h]], axis=0)
    cv2.imwrite(os.path.join(out_dir, f"{iters:06d}.png"), montage[:, :, ::-1])


def show_affs_emb(iters: int, image_hwc: np.ndarray, ema_image_hwc: np.ndarray,
                  pred_aff: np.ndarray, gt_aff: np.ndarray,
                  embedding_hwc: np.ndarray, ema_embedding_hwc: np.ndarray,
                  out_dir: str):
    """Train-time montage: inputs, EMA view, affinities, embedding PCAs."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    row1 = np.concatenate([_to_u8(image_hwc), _to_u8(ema_image_hwc)], axis=1)
    row2 = np.concatenate([np.repeat(_to_u8(pred_aff)[..., None], 3, -1),
                           np.repeat(_to_u8(gt_aff)[..., None], 3, -1)], axis=1)
    row3 = np.concatenate([embedding_pca(embedding_hwc),
                           embedding_pca(ema_embedding_hwc)], axis=1)
    w = min(row1.shape[1], row2.shape[1], row3.shape[1])
    montage = np.concatenate([row1[:, :w], row2[:, :w], row3[:, :w]], axis=0)
    cv2.imwrite(os.path.join(out_dir, f"{iters:06d}.png"), montage[:, :, ::-1])
