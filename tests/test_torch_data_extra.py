"""The rest of the JAX package's data and model code in the port, on the
CPU: the augmentations of ``data/augment2d.py`` that no sampler calls
(bit-equal where the JAX function is numpy and scipy only; ``random_affine``
warps without cv2, images within 1e-4 of cv2's and labels equal, with the
same draws from the same generator), the synthetic CVPPP and BBBC datasets
(``synthesize``: the decoded files equal to those the JAX function writes)
and ``ResidualUNet2D`` (the single-head model: outputs within 1e-4 of the
largest Flax output on the same weights, TF32 irrelevant on the CPU)."""

import os

import cv2
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.data import augment2d as jax_aug
from pixel_embedded_affinity_tpu.data import bbbc as jax_bbbc
from pixel_embedded_affinity_tpu.data import consistency as jax_consistency
from pixel_embedded_affinity_tpu.data import cvppp as jax_cvppp
from pixel_embedded_affinity_tpu.data import device_warp as jax_warp
from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2D as FlaxResUNet2D

from pixel_embedded_affinity_torch.convert import resunet2d_from_flax
from pixel_embedded_affinity_torch.data import augment2d, bbbc, consistency, cvppp, device_warp
from pixel_embedded_affinity_torch.models import ResidualUNet2D

from synth import blob_labels


def _both(fn_ours, fn_jax, *args, seed=0, **kw):
    """Each function with its own generator from one seed; the generators
    must end in the same state (the same draws)."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    out = fn_ours(*args, r1, **kw), fn_jax(*args, r2, **kw)
    assert r1.bit_generator.state == r2.bit_generator.state
    return out


def _stack(seed, d=6, h=40, w=44):
    return np.random.default_rng(seed).random((d, h, w)).astype(np.float32)


def test_random_rotate90_matches_jax():
    img = np.random.default_rng(1).random((20, 30, 3)).astype(np.float32)
    lab = blob_labels(20, 30, grid=2, radius=4, seed=1)
    for seed in range(4):
        (oi, ol), (ji, jl) = _both(augment2d.random_rotate90, jax_aug.random_rotate90, img, lab,
                                   seed=seed)
        np.testing.assert_array_equal(oi, ji)
        np.testing.assert_array_equal(ol, jl)


@pytest.mark.parametrize("d,downsample_z", [(1, False), (6, False), (40, True)])
def test_cutblur_and_cutnoise_match_jax(d, downsample_z):
    stack = _stack(2, d=d)
    for seed in range(3):
        ours, theirs = _both(augment2d.cutblur, jax_aug.cutblur, stack, seed=seed,
                             downsample_z=downsample_z)
        np.testing.assert_array_equal(ours, theirs)
        assert not np.array_equal(ours, stack)
    if d > 1:
        ours, theirs = _both(augment2d.cutnoise, jax_aug.cutnoise, stack, seed=3)
        np.testing.assert_array_equal(ours, theirs)


def test_cutblur_of_a_too_thin_z_region_raises_as_in_jax():
    """Downsampling z of a 1-slice region: the resize to 0 slices fails in
    both packages alike."""
    stack = _stack(2, d=6)
    for fn in (augment2d.cutblur, jax_aug.cutblur):
        with np.errstate(divide="ignore", invalid="ignore"), pytest.raises(ValueError):
            fn(stack, np.random.default_rng(0), downsample_z=True)


def test_mixup_and_motion_blur_match_jax():
    batch = _stack(4, d=5)
    for seed in range(3):
        ours, theirs = _both(augment2d.mixup_batch, jax_aug.mixup_batch, batch, seed=seed)
        np.testing.assert_array_equal(ours, theirs)
        ours, theirs = _both(augment2d.motion_blur, jax_aug.motion_blur, batch, seed=seed,
                             sections=3, kernel_size=7)
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("strength", [0, 4])
def test_missing_parts_match_jax(strength):
    stack = _stack(5, d=7, h=48, w=40)
    for seed in range(3):
        ours, theirs = _both(augment2d.missing_parts, jax_aug.missing_parts, stack, seed=seed,
                             iterations=3, deformation_strength=strength, p=0.7)
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("channels", [3, 1, 0], ids=["rgb", "c1", "hw"])
def test_random_affine_matches_jax(channels):
    rng = np.random.default_rng(6)
    shape = (48, 56) if channels == 0 else (48, 56, channels)
    img = rng.random(shape).astype(np.float32)
    lab = blob_labels(48, 56, grid=3, radius=6, seed=6)
    for seed in range(5):
        (oi, ol), (ji, jl) = _both(augment2d.random_affine, jax_aug.random_affine, img, lab,
                                   seed=seed)
        assert oi.shape == ji.shape == (48, 56, max(channels, 1))
        assert np.abs(oi - ji).max() <= 1e-4
        np.testing.assert_array_equal(ol, jl)
        assert ol.dtype == jl.dtype


def _decoded(folder):
    """Every file under ``folder`` as cv2 decodes it (text files as text)."""
    out = {}
    for root, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(root, f)
            key = os.path.relpath(path, folder)
            if f.endswith(".txt"):
                with open(path) as fh:
                    out[key] = fh.read()
            else:
                out[key] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return out


def _same_files(a, b):
    da, db = _decoded(a), _decoded(b)
    assert sorted(da) == sorted(db) and da
    for k in da:
        if isinstance(da[k], str):
            assert da[k] == db[k], k
        else:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_cvppp_synthesize_writes_jax_files(tmp_path):
    kw = dict(n_train=3, h=60, w=52, n_valid=2, n_test=1, seed=3)
    names = cvppp.synthesize(str(tmp_path / "ours"), **kw)
    assert names == jax_cvppp.synthesize(str(tmp_path / "jax"), **kw)
    _same_files(tmp_path / "ours", tmp_path / "jax")


def test_bbbc_synthesize_writes_jax_files(tmp_path):
    kw = dict(n_train=2, n_valid=1, n_test=1, h=64, w=72, seed=4)
    bbbc.synthesize(str(tmp_path / "ours"), **kw)
    jax_bbbc.synthesize(str(tmp_path / "jax"), **kw)
    _same_files(tmp_path / "ours", tmp_path / "jax")


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_residual_unet2d_matches_flax(hw):
    widths, emd = (4, 6, 8, 12, 16), 8
    model = FlaxResUNet2D(out_channels=2, nfeatures=widths, emd=emd)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1,) + hw + (3,)), train=False))
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * (0.3 if "kernel" in name else 0.1)).astype(
            np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    jouts = model.apply(variables, x, train=False)
    port = ResidualUNet2D(3, 2, widths, emd)
    port.load_state_dict(resunet2d_from_flax(variables))
    port.eval()
    with torch.no_grad():
        touts = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(touts) == 2
    for t, j in zip(touts, jouts):
        j = np.asarray(j)
        got = t.permute(0, 2, 3, 1).numpy()
        assert got.shape == j.shape
        assert np.abs(got - j).max() <= 1e-4 * np.abs(j).max()


def test_3d_unflip_and_reflect101_match_jax():
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((8, 3, 6, 6, 4)).astype(np.float32)
    rules = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)], np.float32)
    ours = consistency.convert_consistency_flip_3d(torch.from_numpy(emb), torch.from_numpy(rules))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_consistency.convert_consistency_flip_jax_3d(emb, rules)))
    i = np.arange(-5, 15)
    np.testing.assert_array_equal(device_warp.reflect101_index(torch.from_numpy(i), 9).numpy(),
                                  np.asarray(jax_warp.reflect101_index(jnp.asarray(i), 9)))
