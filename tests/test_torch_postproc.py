"""Port's host decode and metrics vs the JAX package's, on the same
affinities: segmentations bit-equal, metrics equal."""

import numpy as np
import pytest

pytest.importorskip("torch")

from pixel_embedded_affinity_tpu import metrics as jm
from pixel_embedded_affinity_tpu.ops.affinity_np import relabel as j_relabel
from pixel_embedded_affinity_tpu.postproc import (
    merge_func as j_merge, remove_small_object as j_remove_small,
    seg_mutex as j_seg_mutex)

from pixel_embedded_affinity_torch import metrics as tm
from pixel_embedded_affinity_torch.ops import multi_offset, relabel
from pixel_embedded_affinity_torch.postproc import (
    merge_func, remove_small_object, seg_mutex)


def _leaves(h, w, seed):
    """Ellipse instances on background, ids 1..n, plus a few tiny ones."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.zeros((h, w), np.int32)
    for i in range(1, 9):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        ay, ax = rng.uniform(5, 14, 2)
        lab[((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2 <= 1] = i
    for i in range(9, 12):  # 2x2 specks for merge_small to absorb
        y, x = rng.integers(2, h - 3), rng.integers(2, w - 3)
        lab[y:y + 2, x:x + 2] = i
    return lab


def _noisy_affs(lab, offsets, seed):
    """GT affinities (1 inside an instance, 0 across) plus noise."""
    rng = np.random.default_rng(seed)
    h, w = lab.shape
    out = np.zeros((len(offsets), h, w), np.float32)
    for k, (oy, ox) in enumerate(offsets):
        shifted = np.roll(lab, (-oy, -ox), axis=(0, 1))
        out[k] = (shifted == lab).astype(np.float32)
    out += rng.normal(0, 0.25, out.shape).astype(np.float32)
    return np.clip(out, 0, 1)


def _decode(seg_mutex_fn, merge_fn, relabel_fn, affs, offsets, strides, mask):
    seg = seg_mutex_fn(affs, offsets=offsets, strides=strides, mask=mask)
    seg = merge_fn(seg.astype(np.uint16))
    return relabel_fn(seg).astype(np.uint16)


@pytest.mark.parametrize("seed,strides,use_mask", [
    (0, [5, 5], True), (1, [1, 1], False), (2, [2, 3], True)])
def test_decode_bit_equal_and_metrics_equal(seed, strides, use_mask):
    lab = _leaves(90, 110, seed)
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    affs = _noisy_affs(lab, offsets, seed)
    mask = (lab > 0).astype(np.uint8) if use_mask else None
    got = _decode(seg_mutex, merge_func, relabel, affs.copy(), offsets,
                  strides, mask)
    exp = _decode(j_seg_mutex, j_merge, j_relabel, affs.copy(), offsets,
                  strides, mask)
    assert got.max() > 1
    np.testing.assert_array_equal(got, exp)

    gt = lab.astype(np.uint16)
    assert tm.symmetric_best_dice(got, gt) == jm.symmetric_best_dice(exp, gt)
    assert tm.abs_diff_fg_labels(got, gt) == jm.abs_diff_fg_labels(exp, gt)
    assert tm.voi(gt, got) == jm.voi(gt, exp)
    assert tm.adapted_rand_error(gt, got) == jm.adapted_rand_error(gt, exp)


def test_remove_small_object_matches_jax():
    lab = _leaves(60, 70, 3)
    np.testing.assert_array_equal(remove_small_object((lab > 0).astype(np.uint8)),
                                  j_remove_small((lab > 0).astype(np.uint8)))
