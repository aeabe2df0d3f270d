"""The host samplers, their augmentation and targets, and the host-target
train step, against the JAX package's, on the CPU.

The port's ``CVPPPTrain``, ``BBBCTrain`` and ``AC3AC4Train`` take their
draws from a ``np.random.Generator`` in the JAX samplers' order and warp
without cv2. With one seed:

* the warps drawn off (BBBC at ``aug_prob=0``, AC3/AC4 at 0): images,
  labels, EMA views and every target bit-equal to the JAX samplers'.
  CVPPP's crop is always resized: its image is held at the remap bar 1e-5
  (measured 5.4e-7), labels, EMA rule and targets bit-equal;
* the warps on: images within the JAX warp bars' widest, 1e-4 (the
  rescale's; measured 1.2e-5 over the seeds here), labels equal away from
  cv2's rounding ties (at most 1% of pixels; measured 0);
* each warp alone against JAX's ``augment2d`` at its own bar (remap 1e-5,
  rotation 2e-5, rescale 1e-4 in the interior), labels within 1%;
* the host targets of one label bit-equal to JAX's builders, and equal to
  the port's device builders (``ops/targets.py``): affinities and masks
  bit-equal, weights at 1e-5 relative. The host takes each class
  fraction f in float64, the device in float32 (two roundings, 1.2e-7),
  and the majority class's weight f / (1 - f) carries that error times
  1 / (1 - f): 2.4e-6 at f = 0.95 (measured 1.04e-6 on the 3D pyramid).

The host-target step: ``TrainStep2D(device_gt=False, device_ema=False)``
on batches ``CVPPPTrain`` built, against JAX's ``make_train_step_2d``
(``device_gt=False``, ``use_pallas=False``) from one Flax init, over two
steps: losses at 1e-5 relative in float32, parameters in float64 (see the
test). The 3D host-target step matches the port's device-target step on
the same labels.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.data import augment2d as jaug
from pixel_embedded_affinity_tpu.data import ac3ac4 as jac
from pixel_embedded_affinity_tpu.data import bbbc as jbbbc
from pixel_embedded_affinity_tpu.data import consistency as jcons
from pixel_embedded_affinity_tpu.data import cvppp as jcvppp
from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.train.optim import make_optimizer as jax_make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import load_flax_variables, resunet2d_deep_from_flax
from pixel_embedded_affinity_torch.data import ac3ac4, augment2d, bbbc, consistency, cvppp
from pixel_embedded_affinity_torch.data.provider import collate
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep, UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.ops.targets import build_targets_2d, build_targets_3d
from pixel_embedded_affinity_torch.train import (
    TrainState, TrainStep2D, TrainStep3D, make_optimizer)

from synth import blob_labels

FILTERS = (4, 6, 8, 12, 16)
OFFSETS = multi_offset([1, 3, 5, 9, 27], 4)
REMAP, ROTATE, RESCALE, TIES = 1e-5, 2e-5, 1e-4, 0.01
WEIGHT_RTOL = 1e-5


@pytest.fixture(scope="module")
def cvppp_folder(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvppp"))
    jcvppp.synthesize(d, n_train=5, n_valid=1, h=90, w=84, seed=1)
    return d


@pytest.fixture(scope="module")
def bbbc_pairs():
    return bbbc.synthesize_nuclei(3, 120, 130, seed=2)


@pytest.fixture(scope="module")
def bbbc_folder(tmp_path_factory, bbbc_pairs):
    """A BBBC folder of ``bbbc_pairs``: 16-bit tiffs and instance pngs."""
    import cv2

    d = tmp_path_factory.mktemp("bbbc")
    for sub in ("images", "masks_instance", "metadata"):
        os.makedirs(d / sub)
    names = [f"n{i}" for i in range(len(bbbc_pairs))]
    for n, (img, lab) in zip(names, bbbc_pairs):
        cv2.imwrite(str(d / "images" / f"{n}.tif"), (img * 1000).astype(np.uint16))
        cv2.imwrite(str(d / "masks_instance" / f"{n}.png"), lab.astype(np.uint16))
    (d / "metadata" / "training.txt").write_text("".join(f"{n}.png\n" for n in names))
    return str(d)


@pytest.fixture(scope="module")
def volume():
    return ac3ac4.synthesize_volume(12, 100, 100, n_cells=20, seed=3)


def _compare(port: dict, ref: dict, image_atol: float = 0.0, ties: float = 0.0):
    """Keys, shapes and dtypes equal; float arrays within ``image_atol``
    for the images (targets bit-equal), labels off on at most ``ties``."""
    assert port.keys() == ref.keys()
    for k in ref:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("image", "ema_image"):
            np.testing.assert_allclose(a, b, atol=image_atol, rtol=0, err_msg=k)
        elif k == "seg":
            assert np.mean(a != b) <= ties, k
        elif ties == 0.0:
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("light,device_ema", [(False, False), (True, False), (True, True)],
                         ids=["host-targets", "host-ema", "labels-only"])
def test_cvppp_sampler_matches_jax(cvppp_folder, light, device_ema):
    kw = dict(size=64, light=light, device_ema=device_ema, ema_noise=True)
    ref = jcvppp.CVPPPTrain(cvppp_folder, **kw)
    port = cvppp.CVPPPTrain(cvppp_folder, **kw)
    for seed in range(3):
        _compare(port.sample(np.random.default_rng(seed)), ref.sample(np.random.default_rng(seed)),
                 image_atol=REMAP)


def test_cvppp_sampler_takes_decoded_pairs(cvppp_folder):
    import cv2

    names = sorted(f[:-8] for f in os.listdir(os.path.join(cvppp_folder, "train"))
                   if f.endswith("_rgb.png"))
    read = [(cv2.imread(os.path.join(cvppp_folder, "train", n + "_rgb.png"), cv2.IMREAD_COLOR),
             cv2.imread(os.path.join(cvppp_folder, "train", n + "_label.png"),
                        cv2.IMREAD_UNCHANGED)) for n in names]
    with open(os.path.join(cvppp_folder, "valid_set", "local_20_1.txt")) as f:
        valid = [x.strip() for x in f if x.strip()]
    pairs, _ = cvppp.decoded_split(names, [r[0] for r in read], [r[1] for r in read], valid)
    a = cvppp.CVPPPTrain(size=64, pairs=pairs).sample(np.random.default_rng(5))
    b = cvppp.CVPPPTrain(cvppp_folder, size=64).sample(np.random.default_rng(5))
    _compare(a, b)


@pytest.mark.parametrize("aug_prob", [0.0, 0.8], ids=["warps-off", "warps-on"])
def test_bbbc_sampler_matches_jax(bbbc_folder, bbbc_pairs, aug_prob):
    ref = jbbbc.BBBCTrain(bbbc_folder, size=64, aug_prob=aug_prob)
    port = bbbc.BBBCTrain(bbbc_folder, size=64, aug_prob=aug_prob)
    from_pairs = bbbc.BBBCTrain(size=64, aug_prob=aug_prob,
                                pairs=bbbc.load_pairs(bbbc_folder, "train"))
    for seed in range(6):
        r = ref.sample(np.random.default_rng(seed))
        p = port.sample(np.random.default_rng(seed))
        if aug_prob:
            _compare(p, r, image_atol=RESCALE, ties=TIES)
        else:
            _compare(p, r)
        _compare(from_pairs.sample(np.random.default_rng(seed)), p)


@pytest.mark.parametrize("aug_prob", [0.0, 0.5], ids=["warps-off", "warps-on"])
@pytest.mark.parametrize("light", [False, True], ids=["host-targets", "host-ema"])
def test_ac3ac4_sampler_matches_jax(volume, aug_prob, light):
    kw = dict(crop_size=(8, 32, 32), padding=10, aug_prob=aug_prob, light=light)
    ref = jac.AC3AC4Train("", arrays=volume, **kw)
    port = ac3ac4.AC3AC4Train("", arrays=volume, **kw)
    for seed in range(8):
        r = ref.sample(np.random.default_rng(seed))
        p = port.sample(np.random.default_rng(seed))
        if aug_prob:
            _compare(p, r, image_atol=REMAP, ties=TIES)
        else:
            _compare(p, r)


def _img(h, w, seed, ch=None):
    rng = np.random.default_rng(seed)
    return rng.random((h, w) if ch is None else (h, w, ch)).astype(np.float32)


def _lab(h, w, seed):
    return blob_labels(h, w, grid=4, radius=7, seed=seed)


@pytest.mark.parametrize("fn,atol", [("random_rotate", ROTATE), ("random_rescale", None),
                                     ("elastic_deform", REMAP), ("random_flips", 0.0)])
def test_each_warp_matches_jax(fn, atol):
    for seed in range(4):
        img, lab = _img(72, 72, seed, ch=None if fn != "random_flips" else 3), _lab(72, 72, seed)
        ri, rl = getattr(jaug, fn)(img, lab, np.random.default_rng(seed))
        pi, pl = getattr(augment2d, fn)(img, lab, np.random.default_rng(seed))
        assert pi.shape == ri.shape and pi.dtype == ri.dtype and pl.dtype == rl.dtype
        if atol is None:  # the rescale: the interior at its bar, the labels exact
            np.testing.assert_allclose(pi[6:-6, 6:-6], ri[6:-6, 6:-6], atol=RESCALE, rtol=0)
            assert np.array_equal(pl, rl)
        else:
            np.testing.assert_allclose(pi, ri, atol=atol, rtol=0)
            assert np.mean(pl != rl) <= TIES


def test_resized_crop_and_photometric_draws_match_jax():
    img, lab = _img(90, 110, 7, ch=3), _lab(90, 110, 7)
    for seed in range(4):
        ri, rl = jaug.random_resized_crop(img, lab, 64, np.random.default_rng(seed))
        pi, pl = augment2d.random_resized_crop(img, lab, 64, np.random.default_rng(seed))
        np.testing.assert_allclose(pi, ri, atol=REMAP, rtol=0)
        assert np.array_equal(pl, rl)
        for fn in ("random_grayscale_adjust",):
            assert np.array_equal(getattr(augment2d, fn)(img, np.random.default_rng(seed)),
                                  getattr(jaug, fn)(img, np.random.default_rng(seed)))
        assert np.array_equal(augment2d.elastic_field_np(np.random.default_rng(seed), 40, 50),
                              jaug.elastic_field_np(np.random.default_rng(seed), 40, 50))
        for th, tw in ((64, 64), (120, 100), (80, 130)):
            assert np.array_equal(augment2d.center_crop_pad(img, th, tw),
                                  jaug.center_crop_pad(img, th, tw))


def test_ema_perturbations_match_jax():
    img, fg = _img(64, 64, 8, ch=3), (_lab(64, 64, 8) > 0).astype(np.uint8)
    for seed in range(3):
        for fn, args in (("add_gauss_noise", ()), ("add_intensity", ()), ("add_mask", (fg,)),
                         ("flip_ema_rule", None)):
            a = (getattr(consistency, fn)(np.random.default_rng(seed)) if args is None else
                 getattr(consistency, fn)(img, *args, np.random.default_rng(seed)))
            b = (getattr(jcons, fn)(np.random.default_rng(seed)) if args is None else
                 getattr(jcons, fn)(img, *args, np.random.default_rng(seed)))
            assert np.array_equal(a, b), fn
        rule = jcons.flip_ema_rule(np.random.default_rng(seed))
        assert np.array_equal(consistency.simple_augment(img, rule),
                              jcons.simple_augment(img, rule))
        assert np.array_equal(consistency.simple_augment_reverse(img, rule),
                              jcons.simple_augment_reverse(img, rule))
        # the blur: cv2's GaussianBlur through the device view's kernel
        np.testing.assert_allclose(consistency.add_gauss_blur(img, np.random.default_rng(seed)),
                                   jcons.add_gauss_blur(img, np.random.default_rng(seed)),
                                   atol=1e-5, rtol=0)


def test_host_targets_match_jax_builders_and_the_device_builders():
    label = _lab(64, 64, 9)
    image = _img(64, 64, 9, ch=3)
    ref = jcvppp.build_cvppp_targets(image, label, OFFSETS, 2, True, np.random.default_rng(0))
    got = cvppp.host_targets_2d(label, OFFSETS, 2, True)
    for k, v in got.items():
        assert np.array_equal(v, ref[k]) and v.dtype == ref[k].dtype, k
    ref_b = jbbbc._build_bbbc_targets(image, label, OFFSETS, 2, True, np.random.default_rng(0),
                                      True, True, True)
    got_b = bbbc.build_bbbc_targets(image, label, OFFSETS, 2, True, np.random.default_rng(0))
    _compare(got_b, ref_b)
    # the device builders on the same label
    batch = {k: torch.from_numpy(v[None]) for k, v in got.items()}
    dev = build_targets_2d(torch.from_numpy(label[None].astype(np.int64)), OFFSETS)
    from pixel_embedded_affinity_torch.train.train_step import batch_targets_2d, batch_targets_3d

    host = batch_targets_2d(batch, 2)
    for name, a, b in (("affs", host[0], dev[0]), ("mask", host[2], dev[2])):
        assert torch.equal(a, b), name
    torch.testing.assert_close(host[1], dev[1], atol=0, rtol=WEIGHT_RTOL)
    for (ta, wa, ma), (tb, wb, mb) in zip(host[3], dev[3]):
        assert torch.equal(ta, tb) and torch.equal(ma, mb)
        torch.testing.assert_close(wa, wb, atol=0, rtol=WEIGHT_RTOL)
    # 3D
    vol = ac3ac4.synthesize_volume(8, 40, 40, n_cells=6, seed=4)[1]
    got3 = ac3ac4.host_targets_3d(vol)
    h3 = batch_targets_3d({k: torch.from_numpy(v[None]) for k, v in got3.items()})
    d3 = build_targets_3d(torch.from_numpy(vol[None]))
    assert torch.equal(h3[0], d3[0])
    torch.testing.assert_close(h3[1], d3[1], atol=0, rtol=WEIGHT_RTOL)
    for (ta, wa), (tb, wb) in zip(h3[2], d3[2]):
        assert torch.equal(ta, tb)
        torch.testing.assert_close(wa, wb, atol=0, rtol=WEIGHT_RTOL)


@pytest.fixture(scope="module")
def host_batches(cvppp_folder):
    """Two B=2 batches of CVPPPTrain with every target and the EMA view
    built on the host (the JAX sampler's, equal to the port's above)."""
    s = jcvppp.CVPPPTrain(cvppp_folder, size=64, seed=11)
    return [collate([s.sample() for _ in range(2)]) for _ in range(2)]


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def _jax_host_run(variables, batches, dtype):
    """Two JAX host-target steps (``device_gt=False``) in ``dtype``: (state,
    metrics)."""
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16, dtype=dtype)
    cast = _f64 if dtype == jnp.float64 else (lambda t: t)
    v = cast(variables)
    tx = jax_make_optimizer(1e-4)
    state = JaxTrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                          jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_2d(model, tx, OFFSETS, use_pallas=False, device_gt=False))
    metrics = []
    for b in batches:
        state, _, m = step(state, cast(b))
        metrics.append({k: float(x) for k, x in m.items()})
    return jax.device_get(state), metrics


def _port_host_run(variables, batches, device_gt=False, double=False):
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    load_flax_variables(model, variables)
    if double:
        model.double()
    state = TrainState(model, make_optimizer(model.parameters(), load_config("cvppp").train))
    step = TrainStep2D(OFFSETS, use_pallas=False, device_gt=device_gt, device_ema=False)
    metrics = []
    for b in batches:
        b = _f64(b) if double else b
        _, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()})
        metrics.append({k: float(x) for k, x in m.items()})
    return state, metrics


def test_host_target_step_matches_jax(host_batches):
    """Losses at 1e-5 relative in float32. The parameters: the host-target
    step is bit-equal to the device-target step on the same batch, and
    against JAX's they are held in float64 at ``test_torch_train.py``'s
    float64 bars (rtol 2e-7, atol 1e-6 after rounding to float32). In
    float32 one weight of up2's projection ends 7.75e-5 apart on these
    leaf images, where AMSGrad's first step moves a parameter by lr * g /
    (|g| + eps) and the losses' gradients (loss ~840) differ by float32
    rounding (ROADMAP.md, differences kept on purpose, item 7); float64
    shows the two steps are one function."""
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16)
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False))(host_batches[0]["image"][:1]))
    _, jm = _jax_host_run(variables, host_batches, jnp.float32)
    state, pm = _port_host_run(variables, host_batches)
    for a, b in zip(pm, jm):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)
    dev_state, dev_m = _port_host_run(variables, host_batches, device_gt=True)
    assert dev_m == pm
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, dev_state.model.state_dict()[k]), k

    with jax.enable_x64():
        jstate, jm64 = _jax_host_run(variables, host_batches, jnp.float64)
    state64, pm64 = _port_host_run(variables, host_batches, double=True)
    for a, b in zip(pm64, jm64):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=1e-7, err_msg=k)
    exp = resunet2d_deep_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = state64.model.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].float().numpy(), v.numpy(), rtol=2e-7, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_host_target_step_3d_matches_the_device_target_step(volume, use_pallas):
    s = ac3ac4.AC3AC4Train("", arrays=volume, crop_size=(8, 32, 32), padding=10, seed=4)
    b = {k: torch.from_numpy(v) for k, v in collate([s.sample() for _ in range(2)]).items()}
    losses = []
    for device_gt in (False, True):
        torch.manual_seed(0)
        model = UNetPNIEmbeddingDeep(1, FILTERS, 16)
        step = TrainStep3D(use_pallas=use_pallas, device_gt=device_gt, device_ema=False)
        losses.append(step.loss(model.train(), b)[0].item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
