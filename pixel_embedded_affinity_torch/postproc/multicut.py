"""Multicut baselines (elf's mc_baseline semantics, the native solver), the
JAX package's ``postproc/multicut.py``: per-slice distance-transform
watershed fragments on boundary = max(1 - affs_y, 1 - affs_x), a region
adjacency graph with mean boundary-ness per edge, log-odds costs weighted
by edge size, then greedy additive edge contraction, greedy node moves and
Kernighan-Lin refinement (the reference's multicut_kernighan_lin,
scripts_ac3ac4/utils/lmc.py:6-24); and the lifted multicut, whose lifted
edges weigh the objective but never contract."""

from __future__ import annotations

import numpy as np

from ._native import get_lib
from .watershed import distance_transform_watershed


def transform_probabilities_to_costs(probs: np.ndarray, beta: float = 0.5,
                                     edge_sizes: np.ndarray | None = None) -> np.ndarray:
    """Log-odds costs of boundary probabilities with the boundary bias
    ``beta`` (elf's), weighted by the edge size relative to the largest
    where sizes are given."""
    p = np.clip(probs, 0.001, 1.0 - 0.001)
    costs = np.log((1.0 - p) / p) + np.log((1.0 - beta) / beta)
    if edge_sizes is not None:
        costs = edge_sizes / edge_sizes.max() * costs
    return costs


def rag_mean_affinity(fragments: np.ndarray, affs: np.ndarray):
    """RAG edges (u, v), mean affinity and boundary size per edge."""
    lib = get_lib()
    fragments = np.ascontiguousarray(fragments, dtype=np.uint64)
    affs = np.ascontiguousarray(affs, dtype=np.float32)
    d, h, w = fragments.shape
    flat_f, flat_a = fragments.reshape(-1), affs.reshape(affs.shape[0], -1)
    n_edges = lib.rag_mean_affinity(flat_f, flat_a, d, h, w, None, None, None)
    uv = np.zeros((n_edges, 2), dtype=np.uint64)
    mean = np.zeros(n_edges, dtype=np.float64)
    size = np.zeros(n_edges, dtype=np.float64)
    lib.rag_mean_affinity(flat_f, flat_a, d, h, w, uv.ctypes.data, mean.ctypes.data,
                          size.ctypes.data)
    return uv, mean, size


def multicut_gaec(n_nodes: int, uv: np.ndarray, costs: np.ndarray,
                  local_search: int = 2) -> np.ndarray:
    """GAEC multicut and local search: 0 GAEC only, 1 with greedy
    single-node moves, 2 (the reference's) with Kernighan-Lin refinement
    too."""
    lib = get_lib()
    uv = np.ascontiguousarray(uv.reshape(-1), dtype=np.uint64)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    labels = np.zeros(n_nodes, dtype=np.uint64)
    lib.gaec_multicut(int(n_nodes), len(costs), uv, costs, int(local_search), labels)
    return labels


def lifted_multicut_gaec(n_nodes: int, uv_local: np.ndarray, costs_local: np.ndarray,
                         uv_lifted: np.ndarray, costs_lifted: np.ndarray,
                         local_search: int = 2) -> np.ndarray:
    """Lifted multicut: only locally adjacent pairs contract (GAEC), the
    lifted edges weigh the objective; then greedy node moves and
    lifted-aware Kernighan-Lin refinement (``local_search`` as in
    :func:`multicut_gaec`)."""
    lib = get_lib()
    uv_local = np.ascontiguousarray(uv_local.reshape(-1), np.uint64)
    uv_lifted = np.ascontiguousarray(uv_lifted.reshape(-1), np.uint64)
    costs_local = np.ascontiguousarray(costs_local, np.float64)
    costs_lifted = np.ascontiguousarray(costs_lifted, np.float64)
    labels = np.zeros(n_nodes, dtype=np.uint64)
    lib.lifted_gaec_multicut(int(n_nodes), len(costs_local), uv_local, costs_local,
                             len(costs_lifted), uv_lifted, costs_lifted, int(local_search),
                             labels)
    return labels


def fragments_from_boundary(boundary: np.ndarray) -> np.ndarray:
    """Per-slice distance-transform watershed fragments (D, H, W) uint64,
    ids unique over the volume."""
    fragments = np.zeros(boundary.shape, dtype=np.uint64)
    offset = 0
    for z in range(fragments.shape[0]):
        wsz, max_id = distance_transform_watershed(boundary[z])
        fragments[z] = wsz + offset
        offset += max_id
    return fragments


def compact_ids(fragments: np.ndarray, uv: np.ndarray):
    """(sorted fragment ids, uv as indices into them): the solver's node
    ids, every id of ``uv`` being a fragment id."""
    uniq = np.unique(fragments)
    return uniq, np.searchsorted(uniq, uv).astype(np.uint64)


def labels_to_fragments(fragments: np.ndarray, uniq: np.ndarray,
                        node_labels: np.ndarray) -> np.ndarray:
    """The segmentation: each fragment takes its node's label + 1."""
    lut = np.zeros(int(uniq.max()) + 1, dtype=np.uint64)
    lut[uniq] = node_labels + 1
    return lut[fragments]


def mc_baseline(affs: np.ndarray, fragments: np.ndarray | None = None) -> np.ndarray:
    """affs (>= 3, D, H, W) affinities -> (D, H, W) uint64 segmentation; the
    fragments are computed unless given."""
    inv = 1.0 - np.asarray(affs, dtype=np.float32)
    if fragments is None:
        fragments = fragments_from_boundary(np.maximum(inv[1], inv[2]))
    # edge probability = mean (1 - affinity) across the boundary
    uv, mean_inv, size = rag_mean_affinity(fragments, inv[:3])
    costs = transform_probabilities_to_costs(mean_inv, edge_sizes=size)
    uniq, uv_c = compact_ids(fragments, uv)
    return labels_to_fragments(fragments, uniq, multicut_gaec(len(uniq), uv_c, costs))


def multicut_multi(affs: np.ndarray, fragments: np.ndarray | None = None) -> np.ndarray:
    """The 2D / general form (scripts_cvppp/utils/lmc.py:6-19): :func:`mc_baseline`."""
    return mc_baseline(affs, fragments=fragments)
