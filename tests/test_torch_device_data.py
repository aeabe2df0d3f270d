"""The port's device-resident CVPPP sampler and the EMA view's noise and blur
vs the JAX package's, on the CPU.

Same inputs, made with numpy from a seed (or the JAX package's
``synthesize`` folder, read with cv2), through both packages. Where a JAX
function takes a key, its parameters are drawn here with ``jax.random``
from the key splits the JAX function makes, and fed to the port's
parameterised function:

* ``_fallback_box`` and ``rrc_box_at`` (at JAX's draws) equal;
  ``crop_resize_nearest`` bit-equal; ``crop_resize_bilinear`` within 1e-4
  on the 0-255 scale (float32 coordinates and lerps in another order);
  the whole sample at JAX's draws (the port mirrors the box's indices
  where JAX flips the image first) within the same 1e-4 carried through
  /255 and the ImageNet std, labels bit-equal;
* the loader and ``pack_cvppp_arrays`` bit-equal to JAX's;
* the sampler by its contract and by rates over 3000 draws: the boxes'
  area, aspect and corner against JAX's ``rrc_box``, the flips at 0.5;
* ``_gauss_blur_2d`` at fixed radius and sigma (sigma <= 0 included)
  within 1e-6; the noise's one field over the channels and its std; the
  blur's radius and sigma over 400 draws;
* ``train()`` on the cvppp preset from the device-resident sampler, with
  and without the EMA noise and blur: a resumed run draws the batches of
  an uninterrupted one and ends bit-equal.
"""

import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.data import device_aug as jda
from pixel_embedded_affinity_tpu.data import device_data as jdd
from pixel_embedded_affinity_tpu.data.cvppp import synthesize

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_aug as da
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data.consistency import IMAGENET_STD
from pixel_embedded_affinity_torch.data.cvppp import CVPPPValidation, split_names
from pixel_embedded_affinity_torch.train import load_checkpoint, train
from pixel_embedded_affinity_torch.train.loop import resident_sampler

from synth import blob_labels

T = torch.from_numpy
FILTERS = (4, 6, 8, 12, 16)
IMG_ATOL = 1e-4  # on the 0-255 scale


def _img_lab(h=96, w=120, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 9, (h, w), dtype=np.int32))


@pytest.mark.parametrize("hw", [(544, 544), (530, 500), (100, 300), (300, 100), (31, 17)])
def test_fallback_box_matches_jax(hw):
    assert dd._fallback_box(*hw) == jdd._fallback_box(*hw)


def _jax_box_draws(key):
    """The uniforms ``jdd.rrc_box`` draws from ``key``."""
    k_sc, k_as, k_i, k_j = jax.random.split(key, 4)
    return (np.asarray(jax.random.uniform(k_sc, (10,), minval=0.7, maxval=1.0)),
            np.asarray(jax.random.uniform(k_as, (10,), minval=math.log(3 / 4),
                                          maxval=math.log(4 / 3))),
            float(jax.random.uniform(k_i)), float(jax.random.uniform(k_j)))


@pytest.mark.parametrize("hw", [(544, 544), (128, 96), (20, 200)])
def test_rrc_box_matches_jax_at_its_draws(hw):
    """(20, 200): no attempt fits, the fallback box."""
    for s in range(40):
        key = jax.random.PRNGKey(s)
        exp = tuple(int(v) for v in jdd.rrc_box(key, *hw))
        assert dd.rrc_box_at(*hw, *_jax_box_draws(key)) == exp, s


BOXES = [(0, 0, 96, 120), (10, 7, 60, 80), (3, 40, 93, 41), (50, 0, 17, 23)]


@pytest.mark.parametrize("box", BOXES)
def test_crop_resize_bilinear_matches_jax(box):
    img, _ = _img_lab()
    got = dd.crop_resize_bilinear(T(img), *box, 64).numpy()
    exp = np.asarray(jdd.crop_resize_bilinear(jnp.asarray(img), *(jnp.int32(v) for v in box),
                                              64))
    np.testing.assert_allclose(got, exp, rtol=0, atol=IMG_ATOL)


def test_bilinear_taps_are_float32s_at_the_training_size():
    """The taps of every box side from 300 to 544 resized to 544 equal
    float32 arithmetic with a correctly rounded division, as JAX's on the
    CPU: the port's quotient does not depend on the device's division."""
    d = np.arange(544, dtype=np.float32)
    for n in range(300, 545):
        lo, hi, w = dd._bilinear_coords(n, 3, 544, "cpu")
        f = np.clip((d + np.float32(0.5)) * np.float32(n) / np.float32(544) - np.float32(0.5),
                    np.float32(0), np.float32(n - 1))
        exp_lo = np.floor(f)
        np.testing.assert_array_equal(lo.numpy(), 3 + exp_lo.astype(np.int64))
        np.testing.assert_array_equal(hi.numpy(), 3 + np.minimum(exp_lo + 1, n - 1))
        np.testing.assert_array_equal(w.numpy(), f - exp_lo)


@pytest.mark.parametrize("box", BOXES)
def test_crop_resize_nearest_matches_jax(box):
    _, lab = _img_lab()
    got = dd.crop_resize_nearest(T(lab), *box, 64).numpy()
    exp = np.asarray(jdd.crop_resize_nearest(jnp.asarray(lab), *(jnp.int32(v) for v in box), 64))
    np.testing.assert_array_equal(got, exp)


@pytest.fixture(scope="module")
def stacks():
    pairs = [_img_lab(seed=s) for s in range(4)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.mark.parametrize("seed", range(6))
def test_sample_matches_jax_at_its_draws(stacks, seed):
    imgs, labs = stacks
    key = jax.random.PRNGKey(seed)
    exp = jdd.sample_cvppp(jnp.asarray(imgs), jnp.asarray(labs), key, out=64)
    k_pick, k_hf, k_vf, k_box = jax.random.split(key, 4)
    p = {"k": int(jax.random.randint(k_pick, (), 0, len(imgs))),
         "hflip": bool(jax.random.uniform(k_hf) < 0.5),
         "vflip": bool(jax.random.uniform(k_vf) < 0.5),
         "box": dd.rrc_box_at(*labs.shape[1:], *_jax_box_draws(k_box))}
    got = dd._cvppp_sample(T(imgs), T(labs), p, 64)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(exp["image"]), rtol=0,
                               atol=IMG_ATOL / 255 / IMAGENET_STD.min())
    np.testing.assert_array_equal(got["seg"].numpy(), np.asarray(exp["seg"]))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cvppp"))
    synthesize(path, n_train=6, n_valid=2, h=114, w=84, seed=0)
    return path


@pytest.mark.parametrize("padding", [True, False])
def test_load_cvppp_arrays_matches_jax(folder, padding):
    got = dd.load_cvppp_arrays(folder, padding=padding)
    exp = jdd.load_cvppp_arrays(folder, padding=padding)
    assert got[0].shape == exp[0].shape == ((4, 128, 128, 3) if padding else (4, 114, 84, 3))
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)


def test_split_without_a_valid_file(folder, tmp_path):
    """No valid_set file: the first fifth of the names is held out, as the
    JAX loader holds it out, and validates."""
    from pixel_embedded_affinity_tpu.data.cvppp import CVPPPTrain

    other = str(tmp_path / "cvppp")
    shutil.copytree(folder, other)
    os.remove(os.path.join(other, "valid_set", "local_20_1.txt"))
    names, valid = split_names(other)
    assert names == CVPPPTrain(other, device_ema=True).names and len(names) == 5
    assert valid == CVPPPTrain(other, mode="valid", device_ema=True).names
    assert CVPPPValidation(other).names == valid and len(valid) == 1


def test_sampler_contract(stacks):
    imgs, labs = stacks
    images, labels = T(imgs), T(labs)
    batch = dd.sample_cvppp_batch(images, labels, dd.sampler_generator(555, 3), 3, out=64)
    assert batch["image"].shape == (3, 64, 64, 3) and batch["image"].dtype == torch.float32
    assert batch["seg"].shape == (3, 64, 64) and batch["seg"].dtype == torch.int32
    raw = batch["image"].numpy() * IMAGENET_STD + np.asarray([0.485, 0.456, 0.406], np.float32)
    assert raw.min() >= -1e-6 and raw.max() <= 1 + 1e-6
    assert set(np.unique(batch["seg"].numpy())) <= set(np.unique(labs))
    again = dd.sample_cvppp_batch(images, labels, dd.sampler_generator(555, 3), 3, out=64)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    other = dd.sample_cvppp_batch(images, labels, dd.sampler_generator(555, 4), 3, out=64)
    assert not torch.equal(batch["image"], other["image"])
    # the batch is its samples, drawn in turn from the one generator
    first = dd.sample_cvppp(images, labels, dd.sampler_generator(555, 3), out=64)
    assert all(torch.equal(batch[k][0], first[k]) for k in batch)


def test_draws_match_jax_rates():
    """3000 draws: the boxes' mean area, aspect and corner against JAX's
    rrc_box over 3000 keys, every box inside the image; the image index
    uniform; each flip at 0.5 (bounds 4.5 standard deviations)."""
    H, W, n = 128, 128, 3000
    gen = dd.sampler_generator(0, 0)
    draws = [dd._cvppp_params(gen, 4, H, W) for _ in range(n)]
    got = np.array([d["box"] for d in draws], np.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    exp = np.asarray(jax.vmap(lambda k: jnp.stack(jdd.rrc_box(k, H, W)))(keys), np.float64)
    for a in (got, exp):
        assert (a[:, 0] >= 0).all() and (a[:, 1] >= 0).all()
        assert (a[:, 0] + a[:, 2] <= H).all() and (a[:, 1] + a[:, 3] <= W).all()
    area = [(a[:, 2] * a[:, 3] / (H * W)) for a in (got, exp)]
    assert abs(area[0].mean() - area[1].mean()) < 0.01
    assert abs((got[:, 3] / got[:, 2]).mean() - (exp[:, 3] / exp[:, 2]).mean()) < 0.02
    assert abs(got[:, 0].mean() - exp[:, 0].mean()) < 1.5
    assert abs(got[:, 1].mean() - exp[:, 1].mean()) < 1.5

    def rate(xs, p):
        assert abs(np.mean(xs) - p) < 4.5 * np.sqrt(p * (1 - p) / n), (np.mean(xs), p)

    rate([d["hflip"] for d in draws], 0.5)
    rate([d["vflip"] for d in draws], 0.5)
    rate([d["k"] == 0 for d in draws], 0.25)


# ----------------------------------------------------- EMA noise and blur

@pytest.mark.parametrize("sigmas", [(0.5, 0.45, 0.9, 1.0), (0.0, -1.0, 0.0, 0.3)],
                         ids=["sigma>0", "sigma<=0"])
def test_gauss_blur_matches_jax(sigmas):
    img = np.random.default_rng(0).random((4, 24, 20, 3)).astype(np.float32)
    half = np.array([0, 1, 2, 3], np.int32)
    sigma = np.array(sigmas, np.float32)
    got = da._gauss_blur_2d(T(img), T(half).long(), T(sigma), 3).numpy()
    exp = np.asarray(jda._gauss_blur_2d(jnp.asarray(img), jnp.asarray(half),
                                        jnp.asarray(sigma), 3))
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_gauss_noise_field_and_std():
    """One (H, W) field over the channels; per sample std uniform in [0,
    0.05]: within it, mean 0.025 over 400 samples."""
    img = np.full((400, 16, 16, 3), 0.5, np.float32)
    out = da.add_gauss_noise_2d(T(img), torch.Generator().manual_seed(0)).numpy()
    d = out - img
    np.testing.assert_array_equal(d[..., 0], d[..., 1])
    np.testing.assert_array_equal(d[..., 0], d[..., 2])
    stds = d[..., 0].reshape(400, -1).std(axis=1)
    assert stds.max() <= 0.05 * 1.35 and abs(stds.mean() - 0.025) < 0.003


def test_gauss_blur_draws():
    """The blur at its draws, each sample's radius and sigma drawn in turn
    from the generator: the radius uniform in {0..3}, sigma in [0, 1]
    (400 samples; bounds 4.5 standard deviations)."""
    n = 400
    img = T(np.random.default_rng(1).random((n, 9, 9, 1)).astype(np.float32))
    got = da.add_gauss_blur_2d(img, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    zero = torch.zeros(n, dtype=torch.long)
    half = da._randint(gen, zero, zero + 4, (n,))
    sigma = da._uniform(gen, (n,), img)
    torch.testing.assert_close(got, da._gauss_blur_2d(img, half, sigma, 3), rtol=0, atol=0)
    for r in range(4):
        assert abs(float((half == r).double().mean()) - 0.25) < 4.5 * np.sqrt(0.25 * 0.75 / n)
    assert 0 <= float(sigma.min()) and float(sigma.max()) < 1
    assert abs(float(sigma.mean()) - 0.5) < 4.5 * np.sqrt(1 / 12 / n)


def test_ema_view_noise_blur_flags():
    img = np.random.default_rng(2).random((2, 16, 16, 3)).astype(np.float32)
    fg = torch.ones((2, 16, 16), dtype=torch.bool)
    base, rules = da.ema_view_2d(T(img), fg, torch.Generator().manual_seed(3), noise=False,
                                 blur=False, intensity=False, mask=False, flip=False)
    np.testing.assert_array_equal(base.numpy(), img)
    assert not rules.any()
    pert, _ = da.ema_view_2d(T(img), fg, torch.Generator().manual_seed(3), noise=True,
                             blur=True, intensity=False, mask=False, flip=False)
    assert not np.allclose(pert.numpy(), img)
    assert float(pert.min()) >= 0 and float(pert.max()) <= 1


# ------------------------------------------------- device-resident train

def _leaves(n, seed):
    """(image (50, 20, 3) in [0, 1], label) pairs, padded to 64x64."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lab = blob_labels(50, 50, grid=3, radius=6, seed=seed + i)[:, 15:35]
        img = rng.random((50, 20, 3)).astype(np.float32) * 0.3
        img[lab > 0] += 0.5
        out.append((img, lab))
    return out


@pytest.mark.parametrize("ema", [False, True], ids=["default", "ema_noise_blur"])
def test_train_device_resident_resumes_exactly(tmp_path, ema):
    from pixel_embedded_affinity_torch.data.cvppp import PAD, normalize_imagenet

    arrays = dd.pack_cvppp_arrays(_leaves(3, 0))
    valid = [{"image": normalize_imagenet(np.pad(img, PAD + ((0, 0),), mode="reflect")),
              "seg": np.pad(lab, PAD)} for img, lab in _leaves(1, 7)]

    def setup(name, **kw):
        return load_config("cvppp", {
            "model": {"filters": FILTERS}, "data": {"size": 64, "if_ema_noise": ema,
                                                    "if_ema_blur": ema},
            "train": {"display_freq": 1, "valid_freq": 3, "save_freq": 2, **kw},
            "save_path": str(tmp_path / name)})

    cfg = setup("a")
    assert cfg.data.device_resident
    sampler = resident_sampler(cfg, arrays, "cpu")
    b3 = sampler(3)
    assert b3["image"].shape == (2, 64, 64, 3) and all(
        torch.equal(b3[k], sampler(3)[k]) for k in b3)
    state, history = train(cfg, max_iters=3, data_override=(arrays, valid), device="cpu")
    assert state.step == 3 and {"valid/SBD", "valid/loss"} <= set(history[0])
    assert all(np.isfinite(v) for v in history[0].values())
    run = os.path.join(cfg.save_path, cfg.name)
    cfg_b = setup("b", resume=True, if_valid=False)
    run_b = os.path.join(cfg_b.save_path, cfg_b.name)
    os.makedirs(run_b)
    shutil.copy(os.path.join(run, "model-000002.ckpt"), run_b)
    train(cfg_b, max_iters=3, data_override=(arrays, valid), device="cpu")
    a = load_checkpoint(os.path.join(run, "model-000003.ckpt"))
    b = load_checkpoint(os.path.join(run_b, "model-000003.ckpt"))
    # the msgpack trees (params, batch_stats, opt_state, step), bit for bit
    la, lb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.array_equal(x, y), jax.tree_util.keystr(p)


def test_device_resident_refuses_a_host_dataset(tmp_path):
    class Samples:
        def sample(self, rng):
            raise AssertionError

    cfg = load_config("cvppp", {"save_path": str(tmp_path)})
    with pytest.raises(TypeError, match="device_resident=False"):
        train(cfg, max_iters=1, data_override=(Samples(), []), device="cpu")
