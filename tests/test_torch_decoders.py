"""The port's decoders, metrics and embedding clustering against the JAX
package's, on the CPU.

Decoders: segmentations bit-equal to JAX's on the same affinities (the
waterz path with its seed methods, scorings and queue, the 2D lift and
several thresholds; the multicut with each local search, given fragments,
the lifted multicut and the superpixel baselines; pseudo labels), MALIS
weights equal. Metrics (``merge_small_segments``, the SBD family's max,
mean IoU, foreground Dice, ``remap_label(by_size=)``,
``get_fast_pq(match_iou=)``) equal to 1e-12. Clustering:
``cluster_embeddings`` in torch against JAX's, which calls scikit-learn,
at a few hundred points: DBSCAN's labels equal (border points and noise
included), MeanShift's bandwidth within 1e-6 of ``estimate_bandwidth`` and
its partition equal."""

import importlib
import os

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_tpu import metrics as jax_metrics
from pixel_embedded_affinity_tpu.ops.affinity_np import gen_affs_mutex_3d, seg_to_aff_3d
from pixel_embedded_affinity_tpu.postproc import cluster as jax_cluster
from pixel_embedded_affinity_tpu.postproc import malis as jax_malis
from pixel_embedded_affinity_tpu.postproc import mc_baselines as jax_mcb
from pixel_embedded_affinity_tpu.postproc import merge_small as jax_merge
from pixel_embedded_affinity_tpu.postproc import multicut as jax_mc
from pixel_embedded_affinity_tpu.postproc import watershed as jax_ws

from pixel_embedded_affinity_torch import metrics
from pixel_embedded_affinity_torch.postproc import (cluster, malis, mc_baselines, merge_small,
                                                    multicut, watershed)

from synth import blob_labels, partitions_equal, tile_labels_3d

# the packages' postproc/__init__ export the function agglomerate under the module's name
agglomerate = importlib.import_module("pixel_embedded_affinity_torch.postproc.agglomerate")
jax_agg = importlib.import_module("pixel_embedded_affinity_tpu.postproc.agglomerate")


def _affs(seed, d=4, h=48, w=52, noise=0.25):
    """Noisy nearest-neighbour affinities (3, D, H, W) of a brick volume
    with a blob cut into each slice."""
    rng = np.random.default_rng(seed)
    seg = tile_labels_3d(d, h, w, nz=2, ny=2, nx=3)
    for z in range(d):
        blobs = blob_labels(h, w, grid=2, radius=7, seed=seed + z)
        seg[z][blobs > 0] = 100 + blobs[blobs > 0]
    affs = seg_to_aff_3d(seg).astype(np.float32)
    affs = np.clip(affs + noise * rng.standard_normal(affs.shape), 0, 1).astype(np.float32)
    return affs, seg


# ---- watershed, agglomeration

@pytest.mark.parametrize("method", ["grid", "minima", "maxima_distance"])
def test_seeds_and_fragments_match_jax(method):
    affs, _ = _affs(0)
    boundary = 1.0 - 0.5 * (affs[1, 0] + affs[2, 0])
    ours, n = watershed.get_seeds(boundary, method=method, next_id=5, seed_distance=7)
    theirs, jn = jax_ws.get_seeds(boundary, method=method, next_id=5, seed_distance=7)
    np.testing.assert_array_equal(ours, theirs)
    assert n == jn
    np.testing.assert_array_equal(
        watershed.watershed_from_affs(affs, seed_method=method, seed_distance=7),
        jax_ws.watershed_from_affs(affs, seed_method=method, seed_distance=7))
    with pytest.raises(ValueError):
        watershed.get_seeds(boundary, method="other")


@pytest.mark.parametrize("threshold,sigma", [(0.25, 2.0), (0.4, 0.0), (0.3, 1.0)])
def test_distance_transform_watershed_matches_jax(threshold, sigma):
    affs, _ = _affs(1)
    hmap = np.maximum(1 - affs[1, 1], 1 - affs[2, 1])
    ours, n = watershed.distance_transform_watershed(hmap, threshold, sigma)
    theirs, jn = jax_ws.distance_transform_watershed(hmap, threshold, sigma)
    np.testing.assert_array_equal(ours, theirs)
    assert n == jn


@pytest.mark.parametrize("scoring", sorted(agglomerate.SCORING_MODES))
@pytest.mark.parametrize("queue", [256, 0])
def test_agglomerate_scorings_match_jax(scoring, queue):
    affs, _ = _affs(2)
    frags = jax_ws.watershed_from_affs(affs)
    np.testing.assert_array_equal(
        agglomerate.agglomerate(affs, frags, 0.4, scoring=scoring, discretize_queue=queue),
        jax_agg.agglomerate(affs, frags, 0.4, scoring=scoring, discretize_queue=queue))


def test_agglomerate_multi_and_seg_waterz_match_jax():
    affs, _ = _affs(3)
    frags = jax_ws.watershed_from_affs(affs)
    ours = agglomerate.agglomerate_multi(affs, frags, (0.7, 0.3, 0.5))
    theirs = jax_agg.agglomerate_multi(affs, frags, (0.7, 0.3, 0.5))
    assert len(ours) == 3
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for method in ("maxima_distance", "minima"):
        np.testing.assert_array_equal(agglomerate.seg_waterz(affs, 0.5, method),
                                      jax_agg.seg_waterz(affs, 0.5, method))
    # the 2D lift: (K, H, W) affinities, channels 0 and 1 as y and x
    a2 = np.stack([affs[1, 0], affs[2, 0], affs[1, 1]])
    ours2 = agglomerate.seg_waterz(a2, 0.5)
    assert ours2.shape == a2.shape[1:]
    np.testing.assert_array_equal(ours2, jax_agg.seg_waterz(a2, 0.5))


# ---- multicut and the superpixel baselines

@pytest.mark.parametrize("local_search", [0, 1, 2])
def test_multicut_gaec_local_search_matches_jax(local_search):
    affs, _ = _affs(4)
    inv = 1 - affs
    fr = np.zeros(affs.shape[1:], np.uint64)
    off = 0
    for z in range(affs.shape[1]):
        f, n = jax_ws.distance_transform_watershed(np.maximum(inv[1, z], inv[2, z]))
        fr[z] = f + off
        off += n
    np.testing.assert_array_equal(multicut.fragments_from_boundary(np.maximum(inv[1], inv[2])), fr)
    uv, mean, size = jax_mc.rag_mean_affinity(fr, inv)
    costs = jax_mc.transform_probabilities_to_costs(mean, edge_sizes=size)
    np.testing.assert_array_equal(
        multicut.transform_probabilities_to_costs(mean, edge_sizes=size), costs)
    np.testing.assert_array_equal(multicut.transform_probabilities_to_costs(mean, beta=0.3),
                                  jax_mc.transform_probabilities_to_costs(mean, beta=0.3))
    uniq = np.unique(fr)
    uv_c = np.searchsorted(uniq, uv).astype(np.uint64)
    np.testing.assert_array_equal(multicut.multicut_gaec(len(uniq), uv_c, costs, local_search),
                                  jax_mc.multicut_gaec(len(uniq), uv_c, costs, local_search))
    # lifted: long-range pairs two apart in the node order
    rng = np.random.default_rng(5)
    lifted = np.stack([np.arange(len(uniq) - 2), np.arange(2, len(uniq))], 1).astype(np.uint64)
    lc = rng.standard_normal(len(lifted))
    np.testing.assert_array_equal(
        multicut.lifted_multicut_gaec(len(uniq), uv_c, costs, lifted, lc, local_search),
        jax_mc.lifted_multicut_gaec(len(uniq), uv_c, costs, lifted, lc, local_search))


def test_mc_baseline_with_fragments_and_multicut_multi_match_jax():
    affs, seg = _affs(6)
    frags = jax_ws.watershed_from_affs(affs)
    np.testing.assert_array_equal(multicut.mc_baseline(affs, fragments=frags),
                                  jax_mc.mc_baseline(affs, fragments=frags))
    np.testing.assert_array_equal(multicut.multicut_multi(affs), jax_mc.multicut_multi(affs))
    np.testing.assert_array_equal(multicut.multicut_multi(affs, frags),
                                  jax_mc.multicut_multi(affs, frags))


@pytest.mark.parametrize("long_range", [False, True])
def test_superpixel_baselines_match_jax(long_range):
    affs, seg = _affs(7)
    offsets = mc_baselines.LONG_RANGE_OFFSETS
    along = None
    if long_range:
        rng = np.random.default_rng(8)
        along = gen_affs_mutex_3d(seg, offsets)
        along = np.clip(along + 0.2 * rng.standard_normal(along.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(mc_baselines.McSuperpixel()(affs), jax_mcb.McSuperpixel()(affs))
    for ours, theirs in ((mc_baselines.LongRangeMulticutSuperpixel(),
                          jax_mcb.LongRangeMulticutSuperpixel()),
                         (mc_baselines.LmcSuperpixel(), jax_mcb.LmcSuperpixel())):
        np.testing.assert_array_equal(ours(affs, along), theirs(affs, along))


def test_gen_pseudo_labels_match_jax():
    from pixel_embedded_affinity_torch.ops.offsets import shift_channels_offsets

    _, seg = _affs(9)
    offs = shift_channels_offsets(9)
    rng = np.random.default_rng(10)
    a = gen_affs_mutex_3d(seg, offs)
    a = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(mc_baselines.gen_pseudo_labels(a, offs, (1, 4, 4), 30),
                                  jax_mcb.gen_pseudo_labels(a, offs, (1, 4, 4), 30))


@pytest.mark.parametrize("opt_weight", [0.5, 0.2])
def test_malis_weights_match_jax(opt_weight):
    affs, seg = _affs(11, d=3, h=24, w=28)
    seg = seg.astype(np.uint32)
    ours = malis.malis_weights(affs, seg, opt_weight)
    np.testing.assert_array_equal(ours, jax_malis.malis_weights(affs, seg, opt_weight))
    assert ours.sum() > 0
    gt = seg_to_aff_3d(seg).astype(np.float32)
    assert malis.malis_loss(affs, gt, seg, opt_weight) == jax_malis.malis_loss(
        affs, gt, seg, opt_weight)


# ---- metrics

def _pair(seed):
    gt = blob_labels(48, 56, grid=4, radius=6, seed=seed)
    pred = np.roll(blob_labels(48, 56, grid=4, radius=6, seed=seed + 1), 2, axis=1)
    pred[pred == 3] = 0
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_sbd_family_matches_jax(seed):
    pred, gt = _pair(seed)
    assert metrics.symmetric_best_dice_max(pred, gt) == pytest.approx(
        jax_metrics.sbd.symmetric_best_dice_max(pred, gt), abs=1e-12)
    assert metrics.fgbg_dice(pred, gt) == pytest.approx(jax_metrics.sbd.fgbg_dice(pred, gt),
                                                        abs=1e-12)
    assert metrics.mean_iou(pred % 3, gt % 3, 4) == pytest.approx(
        jax_metrics.sbd.mean_iou(pred % 3, gt % 3, 4), abs=1e-12)
    assert metrics.mean_iou(np.zeros((3, 3)), np.zeros((3, 3)) + 5, 2) == 0.0


@pytest.mark.parametrize("by_size", [False, True])
def test_remap_label_matches_jax(by_size):
    pred, _ = _pair(2)
    pred = pred * 7
    pred[:5, :5] = 999  # a small instance with a large id
    ours = metrics.remap_label(pred, by_size=by_size)
    np.testing.assert_array_equal(ours, jax_metrics.bbbc.remap_label(pred, by_size=by_size))
    assert ours.dtype == np.int32
    empty = np.zeros((4, 4), np.int64)
    assert metrics.remap_label(empty, by_size=by_size) is empty


@pytest.mark.parametrize("match_iou", [0.5, 0.7, 0.3, 0.0])
def test_get_fast_pq_matches_jax(match_iou):
    pred, gt = _pair(3)
    pred, gt = metrics.remap_label(pred), metrics.remap_label(gt)
    (ours, our_pairs), (theirs, their_pairs) = (
        metrics.get_fast_pq(gt, pred, match_iou), jax_metrics.bbbc.get_fast_pq(gt, pred, match_iou))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
    assert [list(map(int, p)) for p in our_pairs] == [list(map(int, p)) for p in their_pairs]
    with pytest.raises(ValueError):
        metrics.get_fast_pq(gt, pred, -0.1)


@pytest.mark.parametrize("min_size", [20, 60])
def test_merge_small_segments_matches_jax(min_size):
    _, seg = _affs(12)
    seg = seg.copy()
    seg[1, 10:13, 10:14] = 500  # small segments to merge
    seg[2, 30:32, 5:9] = 501
    np.testing.assert_array_equal(merge_small.merge_small_segments(seg, min_size),
                                  jax_merge.merge_small_segments(seg, min_size))
    pred, _ = _pair(4)
    np.testing.assert_array_equal(merge_small.merge_small_segments(pred, min_size),
                                  jax_merge.merge_small_segments(pred, min_size))


# ---- clustering

def _leaf_embedding(seed, h=40, w=44, c=6, spread=0.05, border=True):
    """An embedding whose foreground instances (blobs) sit at separated
    random centres; a few pixels halfway between two centres (border or
    noise points for DBSCAN)."""
    rng = np.random.default_rng(seed)
    seg = blob_labels(h, w, grid=3, radius=6, seed=seed)
    centres = rng.standard_normal((seg.max() + 1, c)) * 2.0
    emb = centres[seg] + spread * rng.standard_normal((h, w, c))
    if border:
        ys, xs = np.nonzero(seg == 1)
        emb[ys[:3], xs[:3]] = 0.5 * (centres[1] + centres[2])
    return emb.astype(np.float32), seg


@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("eps,min_samples,subsample", [(0.3, 10, 4), (0.5, 5, 2), (0.2, 8, 1)])
def test_dbscan_labels_match_sklearn(eps, min_samples, subsample, expand):
    emb, seg = _leaf_embedding(13)
    fg = (seg > 0).astype(np.uint8)
    kw = dict(method="dbscan", eps=eps, min_samples=min_samples, subsample=subsample,
              expand=expand)
    ours = cluster.cluster_embeddings(emb, fg, device="cpu", **kw)
    np.testing.assert_array_equal(ours, jax_cluster.cluster_embeddings(emb, fg, **kw))
    assert ours.max() >= 5


def test_dbscan_border_points_take_the_earliest_cluster():
    """Two chains within eps of one border point, the second reaching it
    first in index order: the label is the first cluster's, as sklearn's."""
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(14)
    a = rng.normal([0, 0], 0.05, (12, 2))
    b = rng.normal([1.0, 0], 0.05, (12, 2))
    x = np.concatenate([b[:1], a, [[0.5, 0.0]], b[1:], [[5.0, 5.0]]])
    for eps, ms in ((0.46, 5), (0.6, 5), (0.3, 3)):
        ours = cluster.dbscan(torch.from_numpy(x), eps, ms).numpy()
        np.testing.assert_array_equal(ours, DBSCAN(eps=eps, min_samples=ms).fit_predict(x))


@pytest.mark.parametrize("seed,subsample", [(15, 4), (16, 2)])
def test_mean_shift_partition_matches_sklearn(seed, subsample):
    from sklearn.cluster import estimate_bandwidth

    emb, seg = _leaf_embedding(seed, spread=0.1, border=False)
    fg = (seg > 0).astype(np.uint8)
    ys, xs = np.nonzero(fg)
    feats = emb[ys[::subsample], xs[::subsample]]
    bw = cluster.estimate_bandwidth(torch.from_numpy(feats.astype(np.float64)))
    assert abs(bw - estimate_bandwidth(feats)) <= 1e-6
    kw = dict(method="meanshift", subsample=subsample, expand=False)
    ours = cluster.cluster_embeddings(emb, fg, device="cpu", **kw)
    theirs = jax_cluster.cluster_embeddings(emb, fg, **kw)
    assert partitions_equal(ours, theirs)
    assert ((ours > 0) == (theirs > 0)).all()
    assert len(np.unique(ours)) > 2  # a partition into more than one cluster
    # with a bandwidth given
    kw["bandwidth"] = 1.0
    assert partitions_equal(cluster.cluster_embeddings(emb, fg, device="cpu", **kw),
                            jax_cluster.cluster_embeddings(emb, fg, **kw))


def test_cluster_embeddings_edge_cases():
    emb = np.zeros((6, 6, 4), np.float32)
    assert not cluster.cluster_embeddings(emb, np.zeros((6, 6)), device="cpu").any()
    with pytest.raises(ValueError):
        cluster.cluster_embeddings(emb, np.ones((6, 6)), method="kmeans", device="cpu")
