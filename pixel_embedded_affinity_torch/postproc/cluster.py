"""Embedding-space clustering decoders, the JAX package's
``postproc/cluster.py`` (the reference's scripts_cvppp/utils/cluster.py):
DBSCAN or MeanShift over the foreground pixels' embeddings, then a
watershed expansion of the clustered seeds over the mask.

The JAX package calls scikit-learn; the port has its own clustering in
torch, on the device it is given (the card by default), in float64, with
the pairwise distances taken chunk by chunk:

* **DBSCAN**: a point is a core point when at least ``min_samples`` points
  (itself included) lie within ``eps`` (distance <= eps). Clusters are the
  connected components of the core points (min-label propagation with
  pointer jumping), numbered in the order of their lowest-index core
  point; a border point takes the earliest cluster with a core point
  within ``eps``; the rest is noise (-1). That is scikit-learn's
  ``dbscan_inner`` order, so the labels are its labels.
* **MeanShift** (flat kernel, every point a seed, ``cluster_all``): the
  bandwidth, when not given, is scikit-learn's ``estimate_bandwidth`` at
  quantile 0.3 (the mean distance to the k-th nearest point, k = 30% of
  the points, itself included); each seed moves to the mean of the points
  within the bandwidth until it moves by at most 1e-3 bandwidth or after
  300 iterations; the centres, ranked by the number of points within the
  bandwidth of their last step (then by their coordinates, descending),
  suppress the later centres within the bandwidth; each point takes its
  nearest centre. The labels are the partition scikit-learn's gives; their
  numbers follow the same ranking.
"""

from __future__ import annotations

import numpy as np
import torch

from .watershed import seeded_watershed

MAX_ITER = 300
QUANTILE = 0.3
_CHUNK_ELEMENTS = 1 << 26  # distances a chunk of rows computes at once


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, _CHUNK_ELEMENTS // max(n_cols, 1))
    for start in range(0, n_rows, step):
        yield slice(start, min(start + step, n_rows))


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances, each from the differences (no |a|^2 + |b|^2 -
    2ab cancellation)."""
    return torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")


def dbscan(x: torch.Tensor, eps: float = 0.3, min_samples: int = 10) -> torch.Tensor:
    """DBSCAN labels (n,) int64 of the points ``x`` (n, c), -1 for noise."""
    n = x.shape[0]
    counts = torch.zeros(n, dtype=torch.int64, device=x.device)
    for rows in _row_chunks(n, n):
        counts[rows] = (_dist(x[rows], x) <= eps).sum(dim=1)
    core = counts >= min_samples
    core_idx = torch.nonzero(core).flatten()
    xc = x[core_idx]
    m = core_idx.numel()
    big = torch.iinfo(torch.int64).max
    # components of the core graph: each core point's label becomes the
    # least index (into core_idx) of its component
    lab = torch.arange(m, device=x.device)
    while m:
        new = lab.clone()
        for rows in _row_chunks(m, m):
            near = _dist(xc[rows], xc) <= eps
            cand = torch.where(near, lab[None, :], big).amin(dim=1)
            new[rows] = torch.minimum(new[rows], cand)
        while True:  # pointer jumping
            nxt = new[new]
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, lab):
            break
        lab = new
    comp = torch.full((n,), big, dtype=torch.int64, device=x.device)
    comp[core_idx] = lab
    # border points: the least component label among their core neighbours
    border = torch.nonzero(~core).flatten()
    if m and border.numel():
        for rows in _row_chunks(border.numel(), m):
            near = _dist(x[border[rows]], xc) <= eps
            comp[border[rows]] = torch.where(near, lab[None, :], big).amin(dim=1)
    labels = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    found = comp != big
    if found.any():
        # clusters numbered in the order of their least core index
        labels[found] = torch.unique(comp[found], return_inverse=True)[1]
    return labels


def estimate_bandwidth(x: torch.Tensor, quantile: float = QUANTILE) -> float:
    """scikit-learn's ``estimate_bandwidth`` over all points: the mean over
    the points of the distance to their k-th nearest point (itself the
    first), k = int(n * quantile), at least 1."""
    n = x.shape[0]
    k = max(int(n * quantile), 1)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for rows in _row_chunks(n, n):
        total += torch.kthvalue(_dist(x[rows], x), k, dim=1).values.sum()
    return float(total / n)


def mean_shift(x: torch.Tensor, bandwidth: float | None = None,
               max_iter: int = MAX_ITER) -> torch.Tensor:
    """MeanShift labels (n,) int64 of the points ``x`` (n, c)."""
    if bandwidth is None:
        bandwidth = estimate_bandwidth(x)
    n = x.shape[0]
    stop = 1e-3 * bandwidth
    means = x.clone()
    within = torch.zeros(n, dtype=torch.int64, device=x.device)
    active = torch.ones(n, dtype=torch.bool, device=x.device)
    for _ in range(max_iter + 1):
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        for rows in _row_chunks(idx.numel(), n):
            sel = idx[rows]
            near = (_dist(means[sel], x) <= bandwidth).to(x.dtype)
            cnt = near.sum(dim=1)
            has = cnt > 0
            new = (near @ x) / cnt.clamp(min=1)[:, None]
            shift = torch.linalg.vector_norm(new - means[sel], dim=1)
            within[sel] = cnt.long()
            means[sel] = torch.where(has[:, None], new, means[sel])
            # a seed stops once it moved by at most the threshold, or when
            # no point lies within the bandwidth (it then drops out)
            active[sel] = has & (shift > stop)
    keep = within > 0
    centers, intensity = means[keep], within[keep]
    # rank: intensity, then the coordinates, all descending (stable sorts
    # from the last key to the first)
    order = torch.arange(centers.shape[0], device=x.device)
    for j in range(centers.shape[1] - 1, -1, -1):
        order = order[torch.sort(centers[order, j], descending=True, stable=True).indices]
    order = order[torch.sort(intensity[order], descending=True, stable=True).indices]
    centers = centers[order]
    unique = torch.ones(centers.shape[0], dtype=torch.bool, device=x.device)
    i = 0
    while i < centers.shape[0]:
        unique &= (_dist(centers[i:i + 1], centers)[0] > bandwidth)
        unique[i] = True
        rest = torch.nonzero(unique[i + 1:]).flatten()
        if rest.numel() == 0:
            break
        i = i + 1 + int(rest[0])
    kept = centers[unique]
    labels = torch.empty(n, dtype=torch.int64, device=x.device)
    for rows in _row_chunks(n, kept.shape[0]):
        labels[rows] = _dist(x[rows], kept).argmin(dim=1)
    return labels


def cluster_embeddings(embedding_hwc, fg_mask: np.ndarray, method: str = "dbscan",
                       eps: float = 0.3, min_samples: int = 10,
                       bandwidth: float | None = None, subsample: int = 4,
                       expand: bool = True, device="cuda") -> np.ndarray:
    """Cluster the foreground pixels' embeddings (every ``subsample``-th
    foreground pixel in row-major order) into instances, on ``device``.
    Returns (H, W) int32 labels: the clustered pixels' labels + 1 (noise
    0), expanded over the foreground by a watershed on a flat cost unless
    ``expand`` is False."""
    emb = torch.as_tensor(np.asarray(embedding_hwc) if not torch.is_tensor(embedding_hwc)
                          else embedding_hwc)
    h, w, _ = emb.shape
    ys, xs = np.nonzero(fg_mask)
    if len(ys) == 0:
        return np.zeros((h, w), np.int32)
    sub = slice(None, None, max(subsample, 1))
    pix = torch.from_numpy(ys[sub] * w + xs[sub])
    feats = emb.reshape(h * w, -1)[pix.to(emb.device)].to(device=device, dtype=torch.float64)
    if method == "dbscan":
        labels = dbscan(feats, eps=eps, min_samples=min_samples)
    elif method == "meanshift":
        labels = mean_shift(feats, bandwidth=bandwidth)
    else:
        raise ValueError(method)
    seeds = np.zeros((h, w), np.int32)
    seeds[ys[sub], xs[sub]] = labels.cpu().numpy() + 1  # noise (-1) -> 0
    if not expand:
        return seeds
    cost = np.where(fg_mask > 0, 0.0, 1.0).astype(np.float32)
    out = seeded_watershed(cost, seeds)
    out[fg_mask == 0] = 0
    return out
