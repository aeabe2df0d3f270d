"""The port's host utilities against the JAX package's, on the CPU:
``utils/show.py`` (label colours, embedding PCA and SLIC, the montages,
pixel for pixel), the validation montage that the 2D trainer writes,
``utils/flops.py`` (the counts, JAX's integers), ``utils/ema.py``,
``utils/seed.py``, ``utils/profiling.py`` and ``train/freeze.py`` (one and
two optimizer updates against JAX's ``freeze_by_prefix(tx)`` at 5e-5, the
bar of the port's AMSGrad against optax; frozen parameters bit-equal)."""

import os
import random

import cv2
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.ops import affinity_np as jax_affinity_np
from pixel_embedded_affinity_tpu.train import freeze as jax_freeze
from pixel_embedded_affinity_tpu.train.optim import make_optimizer as jax_make_optimizer
from pixel_embedded_affinity_tpu.utils import ema as jax_ema
from pixel_embedded_affinity_tpu.utils import flops as jax_flops
from pixel_embedded_affinity_tpu.utils import show as jax_show

from pixel_embedded_affinity_torch.train.freeze import freeze_by_prefix, trainable_param_count
from pixel_embedded_affinity_torch.train.optim import SGD, AMSGrad
from pixel_embedded_affinity_torch.utils import ema, flops, show
from pixel_embedded_affinity_torch.utils.profiling import ThroughputMeter, trace_context
from pixel_embedded_affinity_torch.utils.seed import setup_seed

from synth import blob_labels


def _png(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def _labels(seed, h=40, w=48):
    return blob_labels(h, w, grid=3, radius=7, seed=seed).astype(np.int64)


# ---- utils/show.py

def test_draw_fragments_match_jax():
    seg = _labels(0)
    np.testing.assert_array_equal(show.draw_fragments_2d(seg), jax_show.draw_fragments_2d(seg))
    vol = np.stack([_labels(s) for s in range(3)])
    np.testing.assert_array_equal(show.draw_fragments_3d(vol, seed=7),
                                  jax_show.draw_fragments_3d(vol, seed=7))


def test_embedding_pca_and_slic_match_jax():
    emb = np.random.default_rng(1).standard_normal((24, 28, 16)).astype(np.float32)
    np.testing.assert_array_equal(show.embedding_pca(emb), jax_show.embedding_pca(emb))
    ours = show.embedding_slic(emb, n_segments=12, n_iter=3)
    np.testing.assert_array_equal(ours, jax_show.embedding_slic(emb, n_segments=12, n_iter=3))
    assert ours.dtype == np.int32 and ours.min() == 1
    labels = np.random.default_rng(2).integers(0, 3, (12, 14))
    np.testing.assert_array_equal(show._enforce_connectivity(labels),
                                  jax_show._enforce_connectivity(labels))


def _montage_arrays(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((40, 48)).astype(np.float32), (rng.random((40, 48)) > 0.5).astype(np.float32),
            _labels(seed), _labels(seed + 1))


def test_val_show_png_is_pixel_equal_to_jax(tmp_path):
    pred, gt_aff, seg, gt = _montage_arrays(3)
    show.val_show(12, pred, gt_aff, seg, gt, str(tmp_path / "ours"))
    jax_show.val_show(12, pred, gt_aff, seg, gt, str(tmp_path / "jax"))
    ours = _png(tmp_path / "ours" / "000012.png")
    assert ours.shape == (80, 96, 3)
    np.testing.assert_array_equal(ours, _png(tmp_path / "jax" / "000012.png"))


def test_show_affs_emb_png_is_pixel_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    args = (rng.random((32, 36, 3)), rng.random((32, 36, 3)), rng.random((32, 36)),
            rng.random((32, 36)), rng.standard_normal((32, 36, 16)),
            rng.standard_normal((32, 36, 16)))
    show.show_affs_emb(5, *args, str(tmp_path / "ours"))
    jax_show.show_affs_emb(5, *args, str(tmp_path / "jax"))
    np.testing.assert_array_equal(_png(tmp_path / "ours" / "000005.png"),
                                  _png(tmp_path / "jax" / "000005.png"))


# ---- the 2D trainer's validation montage

def _valid_setup(tmp_path):
    from pixel_embedded_affinity_torch.config import load_config

    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    segs = [blob_labels(64, 64, grid=3, radius=8, seed=20 + i).astype(np.int32) for i in range(2)]
    valid = [{"image": images[i], "seg": segs[i]} for i in range(2)]

    class OneSample:
        def sample(self, rng):
            return valid[0]

    cfg = load_config("cvppp", {
        "model": {"filters": (4, 6, 8, 12, 16)},
        "train": {"num_workers": 1, "display_freq": 1, "valid_freq": 2, "save_freq": 100},
        "data": {"device_resident": False},
        "save_path": str(tmp_path)})
    return cfg, (OneSample(), valid)


def test_trainer_writes_the_validation_montage_as_jax(tmp_path):
    """train() writes save_path/<name>/valid/<iters>.png at each validation,
    and the PNG equals JAX's val_show of the first validation image's
    arrays: the last predicted and target affinity channel, the decoded and
    true labels (recomputed here from the trained state)."""
    from pixel_embedded_affinity_torch.ops import relabel
    from pixel_embedded_affinity_torch.ops.targets import gen_affs, weight_binary_ratio
    from pixel_embedded_affinity_torch.postproc import merge_func, seg_mutex
    from pixel_embedded_affinity_torch.train import train
    from pixel_embedded_affinity_torch.train.loop import make_train_step
    from pixel_embedded_affinity_torch.train.train_step import make_eval_step_2d

    cfg, data = _valid_setup(tmp_path)
    state, history = train(cfg, max_iters=2, data_override=data, device="cpu")
    valid_dir = tmp_path / cfg.name / "valid"
    assert sorted(os.listdir(valid_dir)) == ["000002.png"]

    offsets = make_train_step(cfg).offsets
    s = data[1][0]
    seg_t = torch.from_numpy(np.asarray(s["seg"], np.int64)[None])
    affs, mask = gen_affs(seg_t, offsets)
    batch = {"image": torch.from_numpy(s["image"][None]), "affs": affs,
             "wmap": weight_binary_ratio(affs), "mask": mask}
    eval_step = make_eval_step_2d(offsets, criterion=make_train_step(cfg).criterion,
                                  use_pallas=cfg.train.use_pallas)
    _, pred, _, _ = eval_step(state.model, batch)
    out_affs = pred[0].float().numpy()
    gt = np.asarray(s["seg"]).astype(np.uint16)
    seg = seg_mutex(out_affs, offsets=offsets, strides=list(cfg.data.strides),
                    mask=(gt > 0).astype(np.uint8)).astype(np.uint16)
    seg = relabel(merge_func(seg, variant="cvppp")).astype(np.uint16)
    # the JAX package's host targets of the same label, as its loop shows them
    jax_affs, _ = jax_affinity_np.gen_affs(np.asarray(s["seg"]), offsets, ignore=False,
                                           padding=True)
    np.testing.assert_array_equal(affs[0].numpy(), jax_affs)
    jax_show.val_show(2, out_affs[-1], jax_affs[-1], seg, gt, str(tmp_path / "jax"))
    np.testing.assert_array_equal(_png(valid_dir / "000002.png"),
                                  _png(tmp_path / "jax" / "000002.png"))


def test_validate_2d_without_show_dir_writes_nothing(tmp_path):
    from pixel_embedded_affinity_torch.train import init_state, validate_2d
    from pixel_embedded_affinity_torch.train.loop import make_train_step
    from pixel_embedded_affinity_torch.train.train_step import make_eval_step_2d

    cfg, data = _valid_setup(tmp_path)
    state = init_state(cfg, torch.device("cpu"))
    step = make_train_step(cfg)
    eval_step = make_eval_step_2d(step.offsets, criterion=step.criterion, use_pallas=False)
    m = validate_2d(cfg, eval_step, state, data[1], step.offsets, "cpu")
    assert "valid/SBD" in m and os.listdir(tmp_path) == []
    validate_2d(cfg, eval_step, state, data[1], step.offsets, "cpu", iters=7,
                show_dir=str(tmp_path / "v"))
    assert os.listdir(tmp_path / "v") == ["000007.png"]


# ---- utils/flops.py

@pytest.mark.parametrize("b,h,w,kw", [
    (4, 544, 544, {}), (2, 256, 256, {"act_bytes": 4}), (1, 128, 96, {"nfeatures": (8, 12, 16, 24, 32)}),
    (2, 544, 544, {"emd": 8, "in_ch": 1, "mask_classes": 3})],
    ids=["cvppp-serve", "bbbc-f32", "gate", "odd"])
def test_resunet2d_flops_match_jax(b, h, w, kw):
    assert flops.resunet2d_flops(b, h, w, **kw) == jax_flops.resunet2d_flops(b, h, w, **kw)
    assert flops.emb2aff2d_flops(b, h, w) == jax_flops.emb2aff2d_flops(b, h, w)
    assert flops.emb2aff2d_flops(b, h, w, 4, 8) == jax_flops.emb2aff2d_flops(b, h, w, 4, 8)


@pytest.mark.parametrize("b,d,h,w,kw", [
    (4, 18, 160, 160, {}), (2, 18, 160, 160, {"act_bytes": 4}),
    (2, 18, 64, 64, {"filters": (4, 6, 8, 12, 16)})], ids=["tile-batch", "step-f32", "gate"])
def test_unet3d_pni_flops_match_jax(b, d, h, w, kw):
    assert flops.unet3d_pni_flops(b, d, h, w, **kw) == jax_flops.unet3d_pni_flops(b, d, h, w, **kw)


def test_chip_peaks_and_roofline():
    peaks = flops.chip_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12,
                     "hbm": 3.35e12}
    assert flops.chip_peaks("NVIDIA A100-SXM4-80GB") is None
    assert flops.chip_peaks("TPU v5 lite") is None
    f = flops.roofline_fields(989e12, 3.35e12, 1.0, "NVIDIA H100 80GB HBM3")
    assert f == {"mfu_pct": 100.0, "hbm_bw_pct": 100.0}
    assert flops.roofline_fields(67e12, 0, 2.0, "NVIDIA H100 80GB HBM3", "f32")["mfu_pct"] == 50.0
    assert flops.roofline_fields(1, 1, 1.0, "unknown card") == {}
    with pytest.raises(ValueError):
        flops.roofline_fields(1, 1, 1.0, "NVIDIA H100 80GB HBM3", "hbm")


# ---- utils/ema.py, utils/seed.py, utils/profiling.py

@pytest.mark.parametrize("step", [0, 3, 1000])
def test_update_ema_variables_matches_jax(step):
    rng = np.random.default_rng(6)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    e = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    theirs = jax_ema.update_ema_variables({k: jnp.asarray(v) for k, v in p.items()},
                                          {k: jnp.asarray(v) for k, v in e.items()}, 0.99, step)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    te = {k: torch.from_numpy(v) for k, v in e.items()}
    tp["n"] = torch.tensor(4)
    te["n"] = torch.tensor(1)
    ours = ema.update_ema_variables(tp, te, 0.99, step)
    for k in p:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(te[k].numpy(), e[k])  # inputs untouched
    assert int(ours["n"]) == 4
    with pytest.raises(KeyError):
        ema.update_ema_variables({"a": tp["a"]}, te, 0.99, step)


@pytest.mark.parametrize("x,n", [(0, 10), (3, 10), (12, 10), (5, 0)])
def test_ramps_match_jax(x, n):
    assert ema.sigmoid_rampup(x, n) == jax_ema.sigmoid_rampup(x, n)
    assert ema.linear_rampup(x, n) == jax_ema.linear_rampup(x, n)
    if n:
        assert ema.cosine_rampdown(x, n) == jax_ema.cosine_rampdown(x, n)


def test_setup_seed_seeds_python_numpy_and_torch():
    def draw():
        return random.random(), np.random.rand(), torch.rand(2).tolist()

    setup_seed(11)
    a = draw()
    setup_seed(11)
    assert draw() == a
    setup_seed(-1)  # seeds nothing
    setup_seed(None)


def test_throughput_meter_and_trace_context(tmp_path):
    m = ThroughputMeter(warmup=2)
    m.step(5.0)
    assert m.rate == 0.0
    m.step(5.0)
    m.step(3.0)
    assert m.items == 3.0 and m.rate > 0
    with trace_context(None) as prof:
        assert prof is None
    with trace_context(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and os.path.getsize(tmp_path / "trace" / "trace.json") > 0


# ---- train/freeze.py

SHAPES = {"inconv": {"w": (3, 4)}, "down1": {"w": (4, 2), "b": (2,)}, "up1": {"w": (2, 5)},
          "outconv": {"b": (5,)}}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_freeze_by_prefix_matches_jax(opt_type):
    params = _tree(7)
    grads = [_tree(8), _tree(9)]
    kw = dict(base_lr=1e-2, opt_type=opt_type)
    tx = jax_freeze.freeze_by_prefix(jax_make_optimizer(**kw), params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    named = {f"{m}.{k}": torch.nn.Parameter(torch.from_numpy(v.copy()))
             for m, leaves in params.items() for k, v in leaves.items()}
    opt = (AMSGrad(named.values(), lr=1e-2, eps=0.01, weight_decay=1e-6) if opt_type == "adam"
           else SGD(named.values(), lr=1e-2))
    assert freeze_by_prefix(opt, named) is opt
    for g in grads:
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for name, p in named.items():
            m, k = name.split(".")
            p.grad = torch.from_numpy(g[m][k].copy())
        opt.step()
        for name, p in named.items():
            m, k = name.split(".")
            if m in ("inconv", "down1"):  # frozen: bit-equal, no state kept
                np.testing.assert_array_equal(p.detach().numpy(), params[m][k])
                assert p not in opt.state
            else:
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][k]), atol=5e-5,
                                           err_msg=name)
                assert not np.array_equal(p.detach().numpy(), params[m][k])
    assert trainable_param_count(named) == jax_freeze.trainable_param_count(params) == 37
    assert (trainable_param_count(named, ("inconv", "down"))
            == jax_freeze.trainable_param_count(params, ("inconv", "down")) == 15)


def test_freeze_by_prefix_drops_state_and_takes_a_module():
    model = torch.nn.Sequential()
    model.add_module("inconv", torch.nn.Linear(3, 4))
    model.add_module("up1", torch.nn.Linear(4, 2))
    opt = AMSGrad(model.parameters(), lr=1e-2)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert len(opt.state) == 4
    freeze_by_prefix(opt, model, ("inconv",))
    assert len(opt.state) == 2 and all(p not in opt.state for p in model.inconv.parameters())
    before = [p.detach().clone() for p in model.inconv.parameters()]
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert all(torch.equal(a, p) for a, p in zip(before, model.inconv.parameters()))
    assert trainable_param_count(model, ("inconv",)) == 10
