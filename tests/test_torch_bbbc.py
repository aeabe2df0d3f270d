"""The port's BBBC039V1 pipeline vs the JAX package's, on the CPU.

Same inputs, made with numpy from a seed (or the JAX package's
``synthesize`` folder, read with cv2), through both packages:

* metrics: AJI, pixel F1, PQ and ``remap_label`` equal (float64 on integer
  counts); the one change, AJI of an empty prediction, shown against the
  JAX function's error;
* data: ``BBBCValidation`` (520x696 geometry, targets, weights) and the
  padded training arrays bit-equal;
* ``device_warp`` at fixed parameters: the blur and the bilinear warps at
  atol 1e-6 (float32 taps and sums in another order), nearest warps and
  coordinates of rescaling and elastic fields exact, rotation coordinates
  at 2e-5 px (float32 cos/sin of two libraries); the whole augmentation
  chain at fixed parameters, image 1e-5, labels equal but where the
  rotation's rounding ties fall otherwise (< 0.5% of pixels);
* the device sampler by its contract: shapes, types, ranges, label ids,
  the plain crop, the seeding, and each gate's rate over 400 draws;
* ``mask_head_loss`` (rtol 1e-6, gradient atol 1e-6) and the train step
  with the mask head over two steps, fused and unfused, at the tolerances
  of ``tests/test_torch_train.py`` (its docstring gives their reasons);
  ``train_state_from_flax`` with the mask head's parameters, statistics
  and AMSGrad moments;
* serving of the ``bbbc039v1`` preset at an odd 72x88: segmentations
  bit-equal, metrics within 5e-3 (as ``tests/test_torch_inference2d.py``
  holds them); the CLI's test mode on a JAX checkpoint.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data import bbbc as jbbbc
from pixel_embedded_affinity_tpu.data import device_data as jdd
from pixel_embedded_affinity_tpu.data import device_warp as jdw
from pixel_embedded_affinity_tpu.infer.inference2d import run_inference_2d as jax_run_inference_2d
from pixel_embedded_affinity_tpu.metrics import bbbc as jm
from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.ops import losses as JL
from pixel_embedded_affinity_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pixel_embedded_affinity_tpu.train.optim import make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d)

from pixel_embedded_affinity_torch import inference as cli
from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import resunet2d_deep_from_flax, train_state_from_flax
from pixel_embedded_affinity_torch.data import BBBCValidation, convert_mask_to_instances
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import device_warp as dw
from pixel_embedded_affinity_torch.data import synthesize_nuclei
from pixel_embedded_affinity_torch.data.device_aug import ema_generator, ema_view_2d
from pixel_embedded_affinity_torch.infer import run_inference_2d, serve_batch
from pixel_embedded_affinity_torch.metrics import bbbc as pm
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.ops import losses as L
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.train import (
    AMSGrad, TrainState, TrainStep2D, load_checkpoint, train)

from synth import blob_labels

T = torch.from_numpy
FILTERS = (4, 6, 8, 12, 16)
OFFSETS = multi_offset([1, 3, 5, 9, 11], 4)
METRIC_ATOL = 5e-3


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bbbc") / "BBBC")
    jbbbc.synthesize(path, n_train=3, n_valid=2, n_test=1, h=160, w=200, seed=0)
    return path


# ---------------------------------------------------------------- metrics

def _label_pair(seed):
    """A ground truth of blobs and a prediction that moves, merges, splits
    and drops some of them and adds a false one."""
    rng = np.random.default_rng(seed)
    gt = blob_labels(64, 72, grid=4, radius=6, seed=seed)
    pred = np.roll(gt, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))), axis=(0, 1))
    pred = np.where(pred == 2, 3, pred)               # merge
    pred[(pred == 5) & (np.arange(72)[None] % 2 == 0)] = 40  # split
    pred[pred == 7] = 0                               # missed
    pred[55:62, 2:9] = 41                             # false positive
    return gt * 3, pred  # ids with gaps: remap_label renumbers them


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbbc_metrics_match_jax(seed):
    gt, pred = _label_pair(seed)
    for x in (gt, pred):
        np.testing.assert_array_equal(pm.remap_label(x), jm.remap_label(x))
    g, p = jm.remap_label(gt), jm.remap_label(pred)
    assert pm.agg_jc_index(g, p) == jm.agg_jc_index(g, p)
    assert pm.pixel_f1(g, p) == jm.pixel_f1(g, p)
    got, exp = pm.get_fast_pq(g, p), jm.get_fast_pq(g, p)
    np.testing.assert_array_equal(got[0], exp[0])
    assert [list(map(int, x)) for x in got[1]] == [list(map(int, x)) for x in exp[1]]


def test_aji_of_an_empty_prediction_is_zero():
    """The JAX function stops at an argmax of an empty sequence; the
    port's gives the formula's value."""
    gt, _ = _label_pair(0)
    empty = np.zeros_like(gt)
    with pytest.raises(ValueError):
        jm.agg_jc_index(jm.remap_label(gt), empty)
    assert pm.agg_jc_index(pm.remap_label(gt), empty) == 0.0
    assert pm.remap_label(empty) is empty
    assert pm.get_fast_pq(pm.remap_label(gt), empty)[0] == jm.get_fast_pq(
        jm.remap_label(gt), empty)[0]


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("mode", ["validation", "test"])
def test_validation_set_matches_jax(folder, mode):
    ours, ref = BBBCValidation(folder, mode=mode), jbbbc.BBBCValidation(folder, mode=mode)
    assert len(ours) == len(ref) == (2 if mode == "validation" else 1)
    for i in range(len(ref)):
        got, exp = ours[i], ref[i]
        assert got["image"].shape == (520, 696, 3) and got["affs"].shape == (10, 520, 696)
        assert set(got) == set(exp)
        for k, v in exp.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


def test_training_arrays_and_pairs_match_jax(folder):
    got, exp = dd.load_bbbc_arrays(folder, padding=30), jdd.load_bbbc_arrays(folder, padding=30)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and g.tobytes() == e.tobytes()
    # the in-memory pairs stand in for the files
    from pixel_embedded_affinity_torch.data.bbbc import load_pairs

    pairs = load_pairs(folder, "validation")
    v = BBBCValidation(folder)
    for i, s in enumerate(BBBCValidation(pairs=pairs)):
        if i == len(v):
            break
        for k, x in v[i].items():
            assert np.array_equal(s[k], x), k


def test_convert_mask_to_instances_matches_jax():
    rng = np.random.default_rng(3)
    mask = (rng.random((60, 70)) > 0.6).astype(np.uint8)
    np.testing.assert_array_equal(convert_mask_to_instances(mask),
                                  jbbbc.convert_mask_to_instances(mask))
    np.testing.assert_array_equal(convert_mask_to_instances(np.zeros((5, 5))),
                                  jbbbc.convert_mask_to_instances(np.zeros((5, 5))))


def test_synthesize_nuclei():
    pairs = synthesize_nuclei(2, 96, 120, seed=4)
    assert len(pairs) == 2
    for img, lab in pairs:
        assert img.shape == lab.shape == (96, 120)
        assert img.dtype == np.float32 and lab.dtype == np.int32
        assert img.min() == 0.0 and img.max() == 1.0
        ids = np.unique(lab)
        assert ids[0] == 0 and 10 < len(ids) <= 80
        # nuclei are brighter than the background
        assert img[lab > 0].mean() > img[lab == 0].mean() + 0.3
    again = synthesize_nuclei(2, 96, 120, seed=4)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(pairs, again))


# ------------------------------------------------------------ device warps

def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w)).astype(np.float32)


def test_blur_and_indices_match_jax():
    np.testing.assert_array_equal(dw.gaussian_kernel1d(4.0), jdw.gaussian_kernel1d(4.0))
    for shape in [(50, 70), (12, 9)]:  # the second narrower than the radius
        x = _img(*shape, seed=0)
        got = dw.gaussian_blur2d(T(x), 4.0).numpy()
        np.testing.assert_allclose(got, np.asarray(jdw.gaussian_blur2d(jnp.asarray(x), 4.0))
                                   if min(shape) > 16 else _np_blur(x), atol=1e-6)
    i = np.arange(-7, 15)
    np.testing.assert_array_equal(dw.reflect_index(T(i), 8).numpy(),
                                  np.asarray(jdw.reflect_index(jnp.asarray(i), 8)))


def _np_blur(x):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(x, 4.0)


@pytest.mark.parametrize("border", ["reflect", "constant"])
@pytest.mark.parametrize("h, w", [(48, 56), (31, 45)])
def test_remaps_match_jax(border, h, w):
    x = _img(h, w, 1)
    lab = np.arange(h * w, dtype=np.int32).reshape(h, w) % 97
    rng = np.random.default_rng(2)
    mx = (rng.random((h, w)) * (w + 8) - 4).astype(np.float32)
    my = (rng.random((h, w)) * (h + 8) - 4).astype(np.float32)
    got = dw.remap_bilinear(T(x), T(mx), T(my), border).numpy()
    exp = np.asarray(jdw.remap_bilinear(jnp.asarray(x), jnp.asarray(mx), jnp.asarray(my), border))
    np.testing.assert_allclose(got, exp, atol=1e-6)
    got = dw.remap_nearest(T(lab), T(mx), T(my), border).numpy()
    exp = np.asarray(jdw.remap_nearest(jnp.asarray(lab), jnp.asarray(mx), jnp.asarray(my),
                                       border))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("angle", [17.3, 90.0, 201.7])
def test_rotation_coords_match_jax(angle):
    got = dw.rotation_coords(angle, 64, 72)
    exp = jdw.rotation_coords(jnp.float32(angle), 64, 72)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=2e-5)


@pytest.mark.parametrize("f", [0.8, 0.93, 1.0, 1.07, 1.2])
def test_rescale_and_elastic_coords_match_jax(f):
    got = dw.rescale_coords(f, 64, 80)
    exp = jdw.rescale_coords(jnp.float32(f), 64, 80, 64, 80)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    rng = np.random.default_rng(6)
    dx, dy = (rng.normal(size=(30, 40)).astype(np.float32) * 5 for _ in range(2))
    for g, e in zip(dw.elastic_coords(T(dx), T(dy)),
                    jdw.elastic_coords(jnp.asarray(dx), jnp.asarray(dy))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_elastic_field_statistics():
    """gaussian_filter(U(-1, 1), 4) * 16: zero mean, the reference
    expression's std (as tests/test_device_warp.py holds the JAX one)."""
    gen = torch.Generator().manual_seed(0)
    dx, dy = dw.elastic_field(gen, 128, 128)
    expected = 16.0 / (2 * 4.0 * np.sqrt(np.pi)) / np.sqrt(3.0)
    for d in (dx, dy):
        assert abs(float(d.mean())) < 0.4
        assert 0.6 * expected < float(d.std()) < 1.4 * expected


def _jax_chain(img, lab, p, key_gs):
    """The JAX sampler's chain body (device_data._bbbc_aug_jax) at fixed
    parameters."""
    h, w = lab.shape
    if p["flip_x"]:
        img, lab = img[:, ::-1], lab[:, ::-1]
    if p["flip_y"]:
        img, lab = img[::-1], lab[::-1]
    if p["angle"] is not None:
        mx, my = jdw.rotation_coords(jnp.float32(p["angle"]), h, w)
        img, lab = (jdw.remap_bilinear(img, mx, my, "constant"),
                    jdw.remap_nearest(lab, mx, my, "constant"))
    if p["scale"] is not None:
        mx, my = jdw.rescale_coords(jnp.float32(p["scale"]), h, w, h, w)
        img, lab = (jdw.remap_bilinear(img, mx, my, "reflect"),
                    jdw.remap_nearest(lab, mx, my, "reflect"))
    if p["elastic"] is not None:
        mx, my = jdw.elastic_coords(*(jnp.asarray(x) for x in p["elastic"]))
        img, lab = (jdw.remap_bilinear(img, mx, my, "constant"),
                    jdw.remap_nearest(lab, mx, my, "constant"))
    if p["gray"] is not None:
        img = jdd._grayscale_single(img, key_gs)
    return np.asarray(img), np.asarray(lab)


@pytest.mark.parametrize("case", range(4))
def test_aug_chain_matches_jax_at_fixed_parameters(case):
    crop = 76
    rng = np.random.default_rng(20 + case)
    img = _img(crop, crop, 30 + case)
    lab = blob_labels(crop, crop, grid=4, radius=7, seed=case)
    dx, dy = (np.asarray(jdw.gaussian_blur2d(jnp.asarray(
        rng.random((crop, crop)).astype(np.float32) * 2 - 1), 4.0)) * 16 for _ in range(2))
    key = jax.random.PRNGKey(case)
    gray = tuple(float(v) for v in jdd._grayscale_params(key))
    on = [(1, 1, 1, 1, 1, 1), (1, 0, 1, 0, 1, 0), (0, 1, 0, 1, 0, 1), (0, 0, 0, 1, 1, 1)][case]
    p = {"flip_x": bool(on[0]), "flip_y": bool(on[1]),
         "angle": float(rng.uniform(0, 360)) if on[2] else None,
         "scale": float(rng.uniform(0.8, 1.2)) if on[3] else None,
         "elastic": (T(dx), T(dy)) if on[4] else None, "gray": gray if on[5] else None}
    got_img, got_lab = dd._bbbc_aug(T(img), T(lab), p)
    jp = dict(p, elastic=(dx, dy) if on[4] else None)
    exp_img, exp_lab = _jax_chain(jnp.asarray(img), jnp.asarray(lab), jp, key)
    np.testing.assert_allclose(got_img.numpy(), exp_img, atol=1e-5)
    # nearest sampling: rounding ties of the rotated coordinates may fall
    # on either side
    assert (got_lab.numpy() != exp_lab).mean() < (5e-3 if on[2] else 1e-12)


# --------------------------------------------------------- device sampler

@pytest.fixture(scope="module")
def arrays():
    return dd.pad_bbbc_arrays(synthesize_nuclei(3, 120, 150, seed=5), padding=30)


def test_sampler_contract(arrays, monkeypatch):
    images, labels = (T(a) for a in arrays)
    batch = dd.sample_bbbc_batch(images, labels, dd.sampler_generator(555, 3), 3, size=64)
    assert batch["image"].shape == (3, 64, 64, 3) and batch["image"].dtype == torch.float32
    assert batch["seg"].shape == (3, 64, 64) and batch["seg"].dtype == torch.int32
    im = batch["image"].numpy()
    assert im.min() >= 0.0 and im.max() <= 1.0
    assert np.array_equal(im[..., 0], im[..., 1]) and np.array_equal(im[..., 0], im[..., 2])
    assert set(np.unique(batch["seg"].numpy())) <= set(np.unique(arrays[1])) | {0}
    again = dd.sample_bbbc_batch(images, labels, dd.sampler_generator(555, 3), 3, size=64)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    other = dd.sample_bbbc_batch(images, labels, dd.sampler_generator(555, 4), 3, size=64)
    assert not torch.equal(batch["image"], other["image"])
    # no augmentation: the centre of a crop of one of the padded images
    monkeypatch.setattr(dd, "AUG_PROB", 0.0)
    plain = dd.sample_bbbc(images, labels, dd.sampler_generator(1, 1), size=64, padding=30)
    gen = dd.sampler_generator(1, 1)
    k, ry, rx = (int(torch.randint(0, n, (1,), generator=gen)) for n in
                 (3, arrays[0].shape[1] - 124 + 1, arrays[0].shape[2] - 124 + 1))
    np.testing.assert_array_equal(plain["image"][..., 0].numpy(),
                                  arrays[0][k, ry + 30:ry + 94, rx + 30:rx + 94])
    np.testing.assert_array_equal(plain["seg"].numpy(), arrays[1][k, ry + 30:ry + 94,
                                                                   rx + 30:rx + 94])


def test_sampler_gates_fire_at_their_rates():
    """400 draws: the chain at 0.8, each link at 0.5 (flips 0.25 per axis),
    the angle uniform in [0, 360), the factor in [0.8, 1.2), the grayscale
    parameters in their ranges; the bounds are 4.5 standard deviations."""
    gen = dd.sampler_generator(0, 0)
    n = 400
    aug, draws = [], []
    for _ in range(n):
        aug.append(dd._uniform(gen)[0] < dd.AUG_PROB)
        draws.append(dd._bbbc_aug_params(gen))

    def rate(xs, p):
        assert abs(np.mean(xs) - p) < 4.5 * np.sqrt(p * (1 - p) / n), (np.mean(xs), p)

    rate(aug, 0.8)
    rate([d["flip_x"] for d in draws], 0.25)
    rate([d["flip_y"] for d in draws], 0.25)
    for key in ("angle", "scale", "elastic", "gray"):
        rate([d[key] is not None for d in draws], 0.5)
    angles = [d["angle"] for d in draws if d["angle"] is not None]
    scales = [d["scale"] for d in draws if d["scale"] is not None]
    assert 0 <= min(angles) and max(angles) < 360 and np.std(angles) > 80
    assert 0.8 <= min(scales) and max(scales) < 1.2
    c, b, g = np.array([d["gray"] for d in draws if d["gray"] is not None]).T
    assert c.min() >= 0.85 and c.max() <= 1.15 and abs(b).max() <= 0.15
    assert g.min() >= 0.5 and g.max() <= 2.0 and abs(np.median(np.log2(g))) < 0.2


# ------------------------------------------------------------ train step

def test_mask_head_loss_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 20, 24, 2)).astype(np.float32) * 3
    target = rng.random((2, 20, 24)) > 0.7
    val, grad = jax.value_and_grad(lambda x: JL.mask_head_loss(x, target))(jnp.asarray(logits))
    t = T(logits).requires_grad_()
    got = L.mask_head_loss(t, T(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), atol=1e-6)
    # the reference's class weights: class 0 by the count of 1s and back
    logp = torch.log_softmax(T(logits).double(), -1).numpy()
    n1, n0 = target.sum(), (~target).sum()
    w = np.where(target, n0, n1)
    pick = np.where(target, logp[..., 1], logp[..., 0])
    np.testing.assert_allclose(float(got.detach()), -(w * pick).sum() / w.sum(), rtol=1e-6)


def _batch(seed):
    rng = np.random.default_rng(seed)
    seg = np.stack([blob_labels(64, 64, grid=3, radius=8, seed=seed + i)
                    for i in range(2)]).astype(np.int32)
    return {"image": rng.random((2, 64, 64, 3)).astype(np.float32),
            "ema_image": rng.random((2, 64, 64, 3)).astype(np.float32),
            "rules": np.array([[1, 0, 1], [0, 1, 1]], np.float32), "seg": seg}


@pytest.fixture(scope="module")
def jax_run():
    """JAX init and 2 JAX steps of the BBBC step (mask head, weight 1000)."""
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16)
    batches = [_batch(1), _batch(2)]
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False))(batches[0]["image"][:1]))
    tx = make_optimizer(1e-4)
    state = JaxTrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_2d(model, tx, OFFSETS, mask_weight=1000.0,
                                      use_pallas=False, device_gt=True))
    steps = []
    for b in batches:
        state, pred, metrics = step(state, b)
        steps.append((jax.device_get(state), np.asarray(pred),
                      {k: float(v) for k, v in metrics.items()}))
    return variables, batches, steps


def _port_state(variables):
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    model.load_state_dict(resunet2d_deep_from_flax(variables))
    return TrainState(model, AMSGrad(model.parameters(), lr=1e-4, eps=0.01,
                                     weight_decay=1e-6))


def _check(state, pred, metrics, jax_state, jax_pred, jax_metrics):
    assert set(metrics) == set(jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(pred.numpy(), jax_pred, atol=2e-3)
    exp = resunet2d_deep_from_flax({"params": jax_state.params,
                                    "batch_stats": jax_state.batch_stats})
    got = state.model.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            atol = 1e-5 if k.endswith(("running_mean", "running_var")) else 5e-5
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_mask_head_train_step_matches_jax_over_two_steps(jax_run, fused):
    variables, batches, steps = jax_run
    state = _port_state(variables)
    step = TrainStep2D(OFFSETS, mask_weight=1000.0, fuse_loss=fused, device_ema=False,
                       imagenet_norm=False)
    for b, (jax_state, jax_pred, jax_metrics) in zip(batches, steps):
        pred, metrics = step(state, {k: T(v) for k, v in b.items()})
        _check(state, pred, metrics, jax_state, jax_pred, jax_metrics)
    # the mask head trained: its weights moved from the init
    init = resunet2d_deep_from_flax(variables)
    assert not torch.equal(state.model.state_dict()["binary_seg.3.weight"],
                           init["binary_seg.3.weight"])


def test_train_state_from_flax_carries_the_mask_head(jax_run):
    _, batches, steps = jax_run
    js = steps[0][0]
    state = _port_state({"params": js.params, "batch_stats": js.batch_stats})
    state.step = train_state_from_flax(js, state.model, state.optimizer)
    named = dict(state.model.named_parameters())
    for name in ("binary_seg.0.weight", "binary_seg.1.weight", "binary_seg.3.bias"):
        st = state.optimizer.state[named[name]]
        assert st["count"] == 1 and float(st["nu_max"].abs().max()) > 0, name
    sd = state.model.state_dict()
    np.testing.assert_array_equal(sd["binary_seg.1.running_var"].numpy(),
                                  np.asarray(js.batch_stats["binary_seg"]["bn"]["var"]))
    pred, metrics = TrainStep2D(OFFSETS, mask_weight=1000.0, device_ema=False)(
        state, {k: T(v) for k, v in batches[1].items()})
    _check(state, pred, metrics, *steps[1])


def test_ema_view_without_imagenet_norm():
    """BBBC's EMA view is drawn on the [0, 1] image itself; cvppp's on the
    de-normalised image, normalised again."""
    b = {k: T(v) for k, v in _batch(3).items() if k in ("image", "seg")}
    raw = TrainStep2D(OFFSETS, imagenet_norm=False).ema_batch(b, 5)
    ema, rules = ema_view_2d(b["image"], b["seg"] > 0, ema_generator(0, 5, "cpu"))
    assert torch.equal(raw["ema_image"], ema) and torch.equal(raw["rules"], rules)
    normed = TrainStep2D(OFFSETS).ema_batch(b, 5)
    assert not torch.allclose(normed["ema_image"], ema)


def test_train_device_resident_validates_and_resumes_exactly(tmp_path, arrays):
    valid = BBBCValidation(pairs=synthesize_nuclei(1, 120, 150, seed=6))

    def setup(name, **kw):
        return load_config("bbbc039v1", {
            "model": {"filters": FILTERS}, "data": {"size": 64},
            "train": {"display_freq": 1, "valid_freq": 3, "save_freq": 2, **kw},
            "save_path": str(tmp_path / name)})

    cfg = setup("a")
    assert cfg.data.device_resident and cfg.train.mask_weight == 1000.0
    timing: dict = {}
    state, history = train(cfg, max_iters=3, data_override=(arrays, valid), device="cpu",
                           timing=timing)
    assert state.step == 3 and len(timing["data_s"]) == 3
    m = history[0]
    assert {"valid/loss", "valid/SBD", "valid/AJI", "valid/F1", "valid/PQ"} <= set(m)
    assert all(np.isfinite(v) for v in m.values())
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


def test_bbbc_preset_matches_jax():
    port, ref = load_config("bbbc039v1"), jax_load_config("bbbc039v1")
    assert port.name == ref.name
    n = 0
    for sec in ("model", "train", "data"):
        p, r = getattr(port, sec), getattr(ref, sec)
        for k in vars(p):
            if k == "dtype":  # "auto": float32 in the port, bfloat16 on a TPU
                continue
            if k in ("bf16_tiled_infer", "fast_tiled_infer"):  # 3D, off by default in the port
                continue
            assert getattr(p, k) == getattr(r, k), f"{sec}.{k}"
            n += 1
    assert n >= 38 and port.data.device_resident


# --------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def serve_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("bbbc_serve")
    samples = [{"image": np.repeat(img[..., None], 3, axis=-1), "seg": lab}
               for img, lab in synthesize_nuclei(3, 72, 88, seed=9)]
    jcfg = jax_load_config("bbbc039v1")
    jcfg.model.filters, jcfg.model.s2d_train, jcfg.model.dtype = FILTERS, False, "float32"
    from pixel_embedded_affinity_tpu.train.loop import build_model

    shapes = jax.eval_shape(lambda: build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 72, 88, 3), np.float32), train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        if "'var'" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    # random weights put every pixel on one side of the mask head; its last
    # bias is moved so that about half the first image is foreground
    logits = jax.jit(lambda v, x: build_model(jcfg).apply(v, x, train=False)[5])(
        variables, samples[0]["image"][None])
    head = variables["params"]["binary_seg"]["conv2"]
    head["bias"][1] -= float(jnp.median(logits[..., 1] - logits[..., 0]))
    out = root / "jax"
    per, agg = jax_run_inference_2d(jcfg, variables, samples, out_dir=str(out), save_h5=True,
                                    use_pallas=False, one_dispatch=False)
    cfg = load_config("bbbc039v1", {"model": {"filters": FILTERS}})
    return dict(root=root, samples=samples, variables=variables, cfg=cfg,
                sd=resunet2d_deep_from_flax(variables), jax=(out, per, agg))


@pytest.mark.parametrize("batch_size", [1, 2, None])
def test_serving_matches_jax(serve_case, batch_size):
    jout, jper, jagg = serve_case["jax"]
    out = serve_case["root"] / f"torch_b{batch_size}"
    timing: dict = {}
    per, agg = run_inference_2d(serve_case["cfg"], serve_case["sd"], serve_case["samples"],
                                out_dir=str(out), timing=timing, batch_size=batch_size,
                                device="cpu")
    with h5py.File(out / "seg.hdf") as ft, h5py.File(jout / "seg.hdf") as fj:
        segs = fj["main"][:]
        assert ft["main"][:].tobytes() == segs.tobytes()
    # the predicted masks are neither empty nor full, so the decode is
    # seeded by the mask head and not by the labels
    assert all(0 < (s > 0).mean() < 0.9 for s in segs)
    assert all(not np.array_equal(s > 0, x["seg"] > 0) for s, x in
               zip(segs, serve_case["samples"]))
    with h5py.File(out / "affs.hdf") as ft, h5py.File(jout / "affs.hdf") as fj:
        np.testing.assert_allclose(ft["main"][:], fj["main"][:], atol=1e-4)
    assert list(per[0]) == list(jper[0]) == ["SBD", "DiC", "VOI", "ARAND", "AJI", "F1",
                                             "DQ", "SQ", "PQ"]
    for t, j in zip(per, jper):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], atol=METRIC_ATOL, err_msg=k)
    for k in jagg:
        np.testing.assert_allclose(agg[k], jagg[k], atol=METRIC_ATOL, err_msg=k)
    assert timing["n_images"] == 3


def test_default_serving_batch_by_shape():
    """Batch 4 where the card was measured to favour it (544x544), else 1:
    at 520x696 batch 4 costs more per image."""
    assert serve_batch((544, 544, 3)) == 4
    assert serve_batch((520, 696, 3)) == serve_batch((72, 88)) == 1


def test_cli_serves_the_test_split(folder, serve_case, tmp_path, capsys):
    v = serve_case["variables"]
    fname = jax_save_checkpoint(str(tmp_path / "models"),
                                {"params": v["params"], "batch_stats": v["batch_stats"],
                                 "step": 3}, 3)
    cli.main(["-c", "bbbc039v1", "-ck", fname, "-m", "test", "--device", "cpu", "-o",
              f"data.data_folder={folder}", f"model.filters={FILTERS}"])
    import json

    lines = capsys.readouterr().out.strip().splitlines()
    agg = json.loads(lines[-1])
    assert {"SBD", "AJI", "F1", "DQ", "SQ", "PQ"} <= set(agg)
    assert json.loads(lines[-2].split("COST TIME:")[1])["n_images"] == 1
