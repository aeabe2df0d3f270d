"""The JAX options that the port took over by name, each held against the
JAX function (``tests/test_torch_inventory.py`` checks that every JAX
parameter has a counterpart or a listed reason):

* ``CVPPPTrain(aug_mode="rsis")``: the "rsis" branch (flips, the image and
  label centre-cropped or padded to ``size``, the affine chain at p = 0.5)
  from one ``np.random.Generator``, as JAX's ``tests/test_extra_components.py``
  builds it (``synthesize(h=114, w=84)``, ``size=128``) and at a size that
  crops: images within 1e-4 (the warps read 1.2e-5 in
  ``tests/test_torch_samplers.py``), labels and host targets equal;
  ``mode`` of ``CVPPPTrain`` and ``BBBCTrain`` (the split each samples);
  the validation sets' target options (``shifts``, ``neighbor``,
  ``separate_weight``), item for item;
* ``load_ac3ac4_arrays(if_dilate=False)``;
* the device samplers' ``scale``, ``ratio`` and ``normalize``
  (``sample_cvppp`` at JAX's draws) and ``aug_prob`` (at 0 the centre of
  the crop at each package's own draws; at 0 and 1 the AC3/AC4 gate);
* the affinity oracles' ``normalize=False``;
* ``gaussian_blend_weight(mu=)`` and ``TiledInference3D(sigma=)``;
* the warps' ``rotation_coords(center=)`` and ``rescale_coords(out_h=,
  out_w=)``;
* ``UNetPNIEmbeddingDeep(bn_momentum_flax=)``: the running statistics after
  a train-mode forward against Flax's;
* ``TrainStep3D(shifts=)`` against ``make_train_step_3d(shifts=)``, one step;
* ``validate_3d``'s ``decoders``, ``crop_size``, ``stride`` and
  ``padding`` against JAX's ``validate_3d`` given the same, on a config
  whose own decoders and crop differ (the quality gates' MSE_ATOL and
  METRIC_ATOL);
* ``make_optimizer(eps=)`` against optax's chain, two updates;
* ``run_inference_2d``: ``out_dir`` alone writes seg.hdf and affs.hdf (JAX's
  ``save_h5`` is listed in the inventory: the port has no second switch);
* the loop's read of ``aug_mode`` (JAX's ``loop.py``): a cvppp data config
  that carries "rsis" trains from the host sampler, and ``build_dataset``
  gives it to ``CVPPPTrain``.
"""

import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

h5py = pytest.importorskip("h5py")
pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.data import bbbc as jbbbc
from pixel_embedded_affinity_tpu.data import cvppp as jcvppp
from pixel_embedded_affinity_tpu.data import device_data as jdd
from pixel_embedded_affinity_tpu.data import device_warp as jdw
from pixel_embedded_affinity_tpu.models.unet3d_pni import UNetPNIEmbeddingDeep as FlaxPNI
from pixel_embedded_affinity_tpu.ops import emb2aff as jemb
from pixel_embedded_affinity_tpu.parallel import tiling as jtiling
from pixel_embedded_affinity_tpu.train.optim import make_optimizer as jax_make_optimizer

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.data import bbbc, cvppp
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import device_warp as dw
from pixel_embedded_affinity_torch.data import synthesize_volume
from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.ops import emb2aff, multi_offset
from pixel_embedded_affinity_torch.parallel import tiling
from pixel_embedded_affinity_torch.train import loop
from pixel_embedded_affinity_torch.train.optim import make_optimizer

IMAGE_ATOL = 1e-4
IMG_ATOL = 1e-4  # the device samplers' images, on the 0-255 scale


def T(a):
    return torch.from_numpy(np.asarray(a))


def _same_sample(got: dict, exp: dict):
    assert got.keys() == exp.keys()
    for k in exp:
        a, b = np.asarray(got[k]), np.asarray(exp[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("image", "ema_image"):
            np.testing.assert_allclose(a, b, atol=IMAGE_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def cvppp_folder(tmp_path_factory):
    """JAX's own case of the rsis branch: 114x84 leaves, padded to 128x128."""
    d = str(tmp_path_factory.mktemp("cvppp"))
    jcvppp.synthesize(d, n_train=4, n_valid=1, h=114, w=84)
    return d


@pytest.fixture(scope="module")
def bbbc_folder(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bbbc"))
    jbbbc.synthesize(d, n_train=3, n_valid=2, n_test=1, h=96, w=112, seed=2)
    return d


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("size", [128, 96], ids=["pad-free", "crop"])
@pytest.mark.parametrize("light,device_ema", [(False, False), (True, True)],
                         ids=["host-targets", "labels-only"])
def test_rsis_branch_matches_jax(cvppp_folder, size, light, device_ema):
    kw = dict(size=size, aug_mode="rsis", light=light, device_ema=device_ema)
    ref = jcvppp.CVPPPTrain(cvppp_folder, **kw)
    port = cvppp.CVPPPTrain(cvppp_folder, **kw)
    for seed in range(4):
        exp = ref.sample(np.random.default_rng(seed))
        _same_sample(port.sample(np.random.default_rng(seed)), exp)
        assert exp["image"].shape == (size, size, 3)


def test_rsis_differs_from_xiaoyu_and_unknown_modes_raise(cvppp_folder):
    a = cvppp.CVPPPTrain(cvppp_folder, size=128, aug_mode="rsis", light=True, device_ema=True)
    b = cvppp.CVPPPTrain(cvppp_folder, size=128, light=True, device_ema=True)
    assert not np.array_equal(a.sample(np.random.default_rng(3))["image"],
                              b.sample(np.random.default_rng(3))["image"])
    with pytest.raises(ValueError, match="aug_mode"):
        cvppp.CVPPPTrain(cvppp_folder, aug_mode="cutmix")


def test_cvppp_mode_selects_the_validation_names(cvppp_folder):
    for mode in ("train", "validation"):
        ref = jcvppp.CVPPPTrain(cvppp_folder, size=64, mode=mode, light=True, device_ema=True)
        port = cvppp.CVPPPTrain(cvppp_folder, size=64, mode=mode, light=True, device_ema=True)
        assert port.names == ref.names and len(port) == len(ref)
        _same_sample(port.sample(np.random.default_rng(1)), ref.sample(np.random.default_rng(1)))
    assert len(cvppp.CVPPPTrain(cvppp_folder, mode="validation").names) == 1


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_bbbc_mode_selects_the_split(bbbc_folder, mode):
    ref = jbbbc.BBBCTrain(bbbc_folder, size=64, mode=mode)
    port = bbbc.BBBCTrain(bbbc_folder, size=64, mode=mode)
    assert port.names == ref.names and len(port) == len(ref) > 0
    _same_sample(port.sample(np.random.default_rng(2)), ref.sample(np.random.default_rng(2)))


@pytest.mark.parametrize("separate_weight", [True, False])
def test_cvppp_validation_targets_match_jax(cvppp_folder, separate_weight):
    kw = dict(shifts=(1, 3, 9), neighbor=8, separate_weight=separate_weight)
    ref = jcvppp.CVPPPValidation(cvppp_folder, **kw)
    port = cvppp.CVPPPValidation(cvppp_folder, **kw)
    assert len(port) == len(ref) == 1
    got, exp = port[0], ref[0]
    assert got.pop("name") == port.names[0]
    got.update(port.targets(0))
    _same_sample(got, exp)
    assert got["affs"].shape[0] == len(port.offsets) == 12


@pytest.mark.parametrize("separate_weight", [True, False])
def test_bbbc_validation_weights_match_jax(bbbc_folder, separate_weight):
    ref = jbbbc.BBBCValidation(bbbc_folder, separate_weight=separate_weight)
    port = bbbc.BBBCValidation(bbbc_folder, separate_weight=separate_weight)
    _same_sample(port[1], ref[1])


def test_load_ac3ac4_arrays_without_dilation_matches_jax(tmp_path):
    raw, lab = synthesize_volume(d=24, h=72, w=72, n_cells=15, seed=0)
    for name, arr in (("AC4_inputs.h5", raw), ("AC4_labels.h5", lab)):
        with h5py.File(tmp_path / name, "w") as f:
            f.create_dataset("main", data=arr)
    got = dd.load_ac3ac4_arrays(str(tmp_path), "ac4", train_split=20, if_dilate=False)
    exp = jdd.load_ac3ac4_arrays(str(tmp_path), "ac4", train_split=20, if_dilate=False)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], lab[:20])
    dilated = dd.load_ac3ac4_arrays(str(tmp_path), "ac4", train_split=20)[1]
    assert (dilated == 0).sum() > (got[1] == 0).sum()


def _box_draws(key, scale, ratio):
    """The uniforms JAX's ``rrc_box`` draws from ``key`` at ``scale`` and
    ``ratio``."""
    k_sc, k_as, k_i, k_j = jax.random.split(key, 4)
    return (np.asarray(jax.random.uniform(k_sc, (10,), minval=scale[0], maxval=scale[1])),
            np.asarray(jax.random.uniform(k_as, (10,), minval=math.log(ratio[0]),
                                          maxval=math.log(ratio[1]))),
            float(jax.random.uniform(k_i)), float(jax.random.uniform(k_j)))


@pytest.mark.parametrize("seed", range(4))
def test_sample_cvppp_scale_ratio_normalize_match_jax(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (3, 96, 120, 3), dtype=np.uint8)
    labs = rng.integers(0, 9, (3, 96, 120), dtype=np.int32)
    scale, ratio = (0.2, 0.5), (0.5, 2.0)
    key = jax.random.PRNGKey(seed)
    exp = jdd.sample_cvppp(jnp.asarray(imgs), jnp.asarray(labs), key, out=64, scale=scale,
                           ratio=ratio, normalize=False)
    k_pick, k_hf, k_vf, k_box = jax.random.split(key, 4)
    p = {"k": int(jax.random.randint(k_pick, (), 0, len(imgs))),
         "hflip": bool(jax.random.uniform(k_hf) < 0.5),
         "vflip": bool(jax.random.uniform(k_vf) < 0.5),
         "box": dd.rrc_box_at(96, 120, *_box_draws(k_box, scale, ratio), ratio)}
    got = dd._cvppp_sample(T(imgs), T(labs), p, 64, normalize=False)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(exp["image"]), rtol=0,
                               atol=IMG_ATOL / 255)
    np.testing.assert_array_equal(got["seg"].numpy(), np.asarray(exp["seg"]))
    # sample_cvppp hands them on: its draws at the generator's, then the sample
    gen = dd.sampler_generator(seed, 0)
    drawn = dd._cvppp_params(dd.sampler_generator(seed, 0), 3, 96, 120, scale, ratio)
    ours = dd.sample_cvppp_batch(T(imgs), T(labs), gen, 1, out=64, scale=scale, ratio=ratio,
                                 normalize=False)
    again = dd._cvppp_sample(T(imgs), T(labs), drawn, 64, normalize=False)
    assert torch.equal(ours["image"][0], again["image"])
    assert float(ours["image"].min()) >= 0.0 and float(ours["image"].max()) <= 1.0


def test_aug_prob_zero_takes_the_centre_of_the_crop_as_jax():
    images, labels = dd.pad_bbbc_arrays([(np.random.default_rng(i).random((80, 90))
                                          .astype(np.float32),
                                          np.random.default_rng(i).integers(0, 5, (80, 90))
                                          .astype(np.int32)) for i in range(3)], padding=30)
    size, pad = 48, 30
    crop = size + 2 * pad
    key = jax.random.PRNGKey(7)
    exp = jdd.sample_bbbc(jnp.asarray(images), jnp.asarray(labels), key, size=size,
                          padding=pad, aug_prob=0.0)
    kp, ky, kx, _, _ = jax.random.split(key, 5)
    k = int(jax.random.randint(kp, (), 0, 3))
    ry = int(jax.random.randint(ky, (), 0, images.shape[1] - crop + 1))
    rx = int(jax.random.randint(kx, (), 0, images.shape[2] - crop + 1))
    centre = np.s_[k, ry + pad:ry + pad + size, rx + pad:rx + pad + size]
    np.testing.assert_array_equal(np.asarray(exp["image"])[..., 0], images[centre])
    np.testing.assert_array_equal(np.asarray(exp["seg"]), labels[centre])
    gen, twin = dd.sampler_generator(3, 1), dd.sampler_generator(3, 1)
    got = dd.sample_bbbc(T(images), T(labels), gen, size=size, padding=pad, aug_prob=0.0)
    k = int(torch.randint(0, 3, (1,), generator=twin))
    ry = int(torch.randint(0, images.shape[1] - crop + 1, (1,), generator=twin))
    rx = int(torch.randint(0, images.shape[2] - crop + 1, (1,), generator=twin))
    centre = np.s_[k, ry + pad:ry + pad + size, rx + pad:rx + pad + size]
    np.testing.assert_array_equal(got["image"][..., 0].numpy(), images[centre])
    np.testing.assert_array_equal(got["seg"].numpy(), labels[centre])


def test_ac3ac4_aug_prob_gates_the_chain_as_jax():
    raw, lab = synthesize_volume(d=14, h=64, w=64, n_cells=10, seed=1)
    raw = raw.astype(np.uint8)
    kw = dict(crop_size=(8, 32, 32), padding=10)
    for prob, aug in ((0.0, False), (1.0, True)):
        p = dd._ac3ac4_params(dd.sampler_generator(0, 0), lab.shape, (8, 52, 52), prob)
        assert p["aug"] is aug
    key = jax.random.PRNGKey(2)
    exp = jdd.sample_ac3ac4(jnp.asarray(raw), jnp.asarray(lab.astype(np.int32)), key,
                            aug_prob=0.0, **kw)
    gen = dd.sampler_generator(5, 0)
    got = dd.sample_ac3ac4(T(raw), T(lab.astype(np.int32)), gen, aug_prob=0.0, **kw)
    # each the unaugmented centre of some crop of the volume
    for sample in (got, exp):
        img = np.asarray(sample["image"])[..., 0]
        seg = np.asarray(sample["seg"])
        hits = [(z, y, x) for z in range(raw.shape[0] - 7) for y in range(raw.shape[1] - 31)
                for x in range(raw.shape[2] - 31)
                if np.array_equal(seg, lab[z:z + 8, y:y + 32, x:x + 32])
                and np.allclose(img, raw[z:z + 8, y:y + 32, x:x + 32] / 255.0, atol=1e-6)]
        assert hits


# ------------------------------------------------------------------ oracles

def test_affinity_oracles_without_normalisation_match_jax():
    rng = np.random.default_rng(0)
    e2 = rng.normal(size=(2, 12, 14, 5)).astype(np.float32)
    offsets = multi_offset([1, 3, 5], neighbor=8)
    for padding in ("valid", "circular"):
        got = emb2aff.embedding_to_affinity_2d(T(e2), offsets, normalize=False,
                                               padding=padding)
        exp = jemb.embedding_to_affinity_2d(jnp.asarray(e2), offsets, normalize=False,
                                            padding=padding)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)
    e3 = rng.normal(size=(1, 6, 30, 32, 4)).astype(np.float32)
    got = emb2aff.embedding_to_affinity_3d(T(e3), normalize=False)
    exp = jemb.embedding_to_affinity_3d(jnp.asarray(e3), normalize=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)
    assert float(got.abs().max()) > 1.5  # not the normalised affinities


def test_blend_weight_mu_and_engine_sigma_match_jax():
    crop = (6, 20, 24)
    for sigma, mu in ((0.2, 0.0), (0.5, 0.3), (0.35, 1.0)):
        np.testing.assert_array_equal(tiling.gaussian_blend_weight(crop, sigma=sigma, mu=mu),
                                      jtiling.gaussian_blend_weight(crop, sigma=sigma, mu=mu))
    got = tiling.TiledInference3D(crop_size=crop, sigma=0.5).weight
    np.testing.assert_array_equal(got, jtiling.TiledInference3D(crop_size=crop, sigma=0.5).weight)
    assert not np.array_equal(got, tiling.TiledInference3D(crop_size=crop).weight)


def test_warp_center_and_output_size_match_jax():
    mx, my = dw.rotation_coords(33.0, 40, 52, center=(11.5, 30.0))
    ex, ey = jdw.rotation_coords(jnp.float32(33.0), 40, 52, center=(11.5, 30.0))
    np.testing.assert_allclose(mx.numpy(), np.asarray(ex), atol=1e-4)
    np.testing.assert_allclose(my.numpy(), np.asarray(ey), atol=1e-4)
    for f, out in ((1.17, (30, 44)), (0.83, (50, 36))):
        mx, my = dw.rescale_coords(f, 40, 52, *out)
        ex, ey = jdw.rescale_coords(jnp.float32(f), 40, 52, *out)
        assert tuple(mx.shape) == out
        np.testing.assert_array_equal(mx.numpy(), np.asarray(ex))
        np.testing.assert_array_equal(my.numpy(), np.asarray(ey))


# ------------------------------------------------------------- model, step

def test_pni_bn_momentum_matches_flax():
    from test_torch_train3d import _flax_variables

    filters, m = (4, 6, 8, 12, 16), 0.9
    x = np.random.default_rng(0).random((1, 8, 32, 32, 1)).astype(np.float32)
    flax = FlaxPNI(filters=filters, emd=16, bn_momentum_flax=m)
    variables = _flax_variables(flax, x)
    _, new = flax.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    exp = unet_pni_deep_from_flax({"params": variables["params"],
                                   "batch_stats": jax.device_get(new["batch_stats"])})
    model = UNetPNIEmbeddingDeep(1, filters, 16, bn_momentum_flax=m)
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    bns = [b for b in model.modules() if isinstance(b, torch.nn.BatchNorm3d)]
    assert bns and all(abs(b.momentum - 0.1) < 1e-12 for b in bns)
    model.train()
    with torch.no_grad():
        model(T(x).permute(0, 4, 1, 2, 3).contiguous())
    got = model.state_dict()
    stats = [k for k in exp if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(), atol=2e-5, err_msg=k)
    assert UNetPNIEmbeddingDeep(1, filters, 16).conv0.block3.momentum == 0.001


def test_3d_step_shift_table_matches_jax():
    from pixel_embedded_affinity_tpu.train.train_step import TrainState as JaxTrainState
    from pixel_embedded_affinity_tpu.train.train_step import make_train_step_3d

    from pixel_embedded_affinity_torch.train import TrainStep3D
    from test_torch_train3d import (FILTERS, _batch, _check_state, _flax_variables,
                                    _port_state, _tensors, RTOL)

    shifts = (1, 1, 1, 2, 2, 2, 5, 4, 4, 3, 9, 9)
    batch = _batch(1)
    flax = FlaxPNI(filters=FILTERS, emd=16)
    variables = _flax_variables(flax, batch["image"][:1])
    tx = jax_make_optimizer(1e-4)
    jstate = JaxTrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    jstate, _, jm = jax.jit(make_train_step_3d(flax, tx, shifts=shifts, use_pallas=False,
                                               device_gt=True))(jstate, batch)
    state = _port_state(variables)
    _, metrics = TrainStep3D(shifts=shifts, device_ema=False)(state, _tensors(batch))
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=RTOL, err_msg=k)
    _check_state(state.model, jax.device_get(jstate))
    _, default = TrainStep3D(device_ema=False)(_port_state(variables), _tensors(batch))
    assert float(default["loss_embedding"]) != float(metrics["loss_embedding"])


def test_validate_3d_keywords_match_jax():
    from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
    from pixel_embedded_affinity_tpu.data.ac3ac4 import AC3AC4ValidVolume as JaxValidVolume
    from pixel_embedded_affinity_tpu.train.loop import validate_3d as jax_validate_3d

    from pixel_embedded_affinity_torch.data import AC3AC4ValidVolume
    from pixel_embedded_affinity_torch.train import validate_3d
    from test_torch_train3d import _flax_variables

    filters = (4, 6, 8, 12, 16)
    geometry = dict(decoders=("mutex",), crop_size=(8, 32, 32), stride=(4, 16, 16),
                    padding=(2, 8, 8))
    raw, label = synthesize_volume(d=12, h=48, w=48, n_cells=8, seed=3)
    jcfg = jax_load_config("ac3ac4")
    jcfg.model.filters = filters
    jcfg.model.dtype, jcfg.model.bf16_tiled_infer = "float32", False
    jcfg.model.fast_tiled_infer = False
    flax = FlaxPNI(filters=filters, emd=16)
    variables = _flax_variables(flax, np.zeros((1, 8, 32, 32, 1), np.float32))
    theirs = jax_validate_3d(jcfg, flax, types.SimpleNamespace(**variables),
                             JaxValidVolume("", arrays=(raw, label)), **geometry)
    cfg = load_config("ac3ac4", {"model": {"filters": filters},
                                 "train": {"valid_decoders": ("waterz",)}})
    model = UNetPNIEmbeddingDeep(1, filters, 16).eval()
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    ours = validate_3d(cfg, types.SimpleNamespace(model=model),
                       AC3AC4ValidVolume("", arrays=(raw, label)), "cpu", **geometry)
    assert set(ours) == set(theirs) and "valid/mutex_voi" in ours
    np.testing.assert_allclose(ours["valid/affs_mse"], theirs["valid/affs_mse"], atol=1e-5)
    np.testing.assert_allclose(ours["valid/mutex_voi"], theirs["valid/mutex_voi"], atol=5e-3)


def test_make_optimizer_eps_matches_optax():
    import optax

    tc = load_config("cvppp", {"train": {"lr_mode": "fixed"}}).train
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(2)]
    tx = jax_make_optimizer(tc.base_lr, eps=0.1, weight_decay=tc.weight_decay)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    ps = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt = make_optimizer(ps, tc, eps=0.1)
    for g in grads:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(ps, g):
            p.grad = T(x.copy())
        opt.step()
    for a, b in zip(ps, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert opt.param_groups[0]["eps"] == 0.1


# ------------------------------------------------------------ entry points

def test_serving_writes_h5_to_out_dir(tmp_path, monkeypatch):
    from pixel_embedded_affinity_torch.infer import inference2d

    def served(cfg, sd, dataset, batch_size, device, clock, with_mask, use_fast):
        for s in dataset:
            yield s, np.zeros((len(cfg.data.shifts) * 2, 16, 16), np.float32), None

    monkeypatch.setattr(inference2d, "_served", served)
    cfg = load_config("cvppp")
    samples = [{"seg": np.ones((16, 16), np.int32)}]
    before = set(os.listdir(tmp_path))
    inference2d.run_inference_2d(cfg, {}, samples, device="cpu")
    assert set(os.listdir(tmp_path)) == before
    inference2d.run_inference_2d(cfg, {}, samples, out_dir=str(tmp_path / "out"), device="cpu")
    assert sorted(os.listdir(tmp_path / "out")) == ["affs.hdf", "seg.hdf"]
    with h5py.File(tmp_path / "out" / "seg.hdf") as f:
        assert f["main"].shape[0] == 1


def test_loop_takes_the_host_sampler_for_an_rsis_config():
    cfg = load_config("cvppp")
    assert loop.uses_resident_sampler(cfg)
    data = types.SimpleNamespace(**vars(cfg.data))
    data.aug_mode = "rsis"
    assert not loop.uses_resident_sampler(types.SimpleNamespace(data=data))
    data.aug_mode = "xiaoyu"
    assert loop.uses_resident_sampler(types.SimpleNamespace(data=data))
    bb = load_config("bbbc039v1").data
    bb_data = types.SimpleNamespace(**vars(bb), aug_mode="rsis")
    assert loop.uses_resident_sampler(types.SimpleNamespace(data=bb_data))
    rsis = types.SimpleNamespace(**vars(cfg.data), aug_mode="rsis")
    train_ds, _ = loop.build_dataset(types.SimpleNamespace(data=rsis, train=cfg.train),
                                     decoded=([], []))
    assert train_ds.aug_mode == "rsis"
    assert loop.build_dataset(cfg, decoded=([], []))[0].aug_mode == "xiaoyu"
