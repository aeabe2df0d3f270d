"""Multicut baseline (elf's mc_baseline semantics, the native solver), the
JAX package's ``postproc/multicut.py``: per-slice distance-transform
watershed fragments on boundary = max(1 - affs_y, 1 - affs_x), a region
adjacency graph with mean boundary-ness per edge, log-odds costs weighted
by edge size, then greedy additive edge contraction, greedy node moves and
Kernighan-Lin refinement."""

from __future__ import annotations

import numpy as np

from ._native import get_lib
from .watershed import distance_transform_watershed

# the native solver's local search: 2 = greedy node moves + Kernighan-Lin
_LOCAL_SEARCH = 2


def transform_probabilities_to_costs(probs: np.ndarray,
                                     edge_sizes: np.ndarray) -> np.ndarray:
    """Log-odds costs of boundary probabilities (elf's, at its default
    boundary bias 0.5, whose log term is 0), weighted by the edge size
    relative to the largest."""
    p = np.clip(probs, 0.001, 1.0 - 0.001)
    return edge_sizes / edge_sizes.max() * np.log((1.0 - p) / p)


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


def multicut_gaec(n_nodes: int, uv: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """GAEC multicut, then greedy single-node moves and Kernighan-Lin
    refinement."""
    lib = get_lib()
    uv = np.ascontiguousarray(uv.reshape(-1), dtype=np.uint64)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    labels = np.zeros(n_nodes, dtype=np.uint64)
    lib.gaec_multicut(int(n_nodes), len(costs), uv, costs, _LOCAL_SEARCH, labels)
    return labels


def mc_baseline(affs: np.ndarray) -> np.ndarray:
    """affs (>= 3, D, H, W) affinities -> (D, H, W) uint64 segmentation."""
    inv = 1.0 - np.asarray(affs, dtype=np.float32)
    boundary = np.maximum(inv[1], inv[2])
    fragments = np.zeros(boundary.shape, dtype=np.uint64)
    offset = 0
    for z in range(fragments.shape[0]):
        wsz, max_id = distance_transform_watershed(boundary[z])
        fragments[z] = wsz + offset
        offset += max_id
    # edge probability = mean (1 - affinity) across the boundary
    uv, mean_inv, size = rag_mean_affinity(fragments, inv[:3])
    costs = transform_probabilities_to_costs(mean_inv, edge_sizes=size)
    # fragment ids -> compact node ids: every id in uv is one of uniq
    uniq = np.unique(fragments)
    node_labels = multicut_gaec(len(uniq), np.searchsorted(uniq, uv).astype(np.uint64),
                                costs)
    lut = np.zeros(int(uniq.max()) + 1, dtype=np.uint64)
    lut[uniq] = node_labels + 1
    return lut[fragments]
