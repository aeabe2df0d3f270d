"""The port's CVPPP train step and loop vs the JAX package's, on the CPU.

The whole step is held against the JAX package's ``make_train_step_2d``
(``use_pallas=False``, ``device_gt=True``, the EMA view and its rules
passed in) over 2 steps from the same Flax init carried across, at
filters (4, 6, 8, 12, 16), 64x64, B=2. Loss metrics at rtol 1e-5 and
BatchNorm statistics at atol 1e-5 (f32 convs summed in another order).
The JAX suite's ``test_fuse_loss_step_matches_unfused`` ties that unfused
JAX step to its fused one; the port is run both ways.

Parameters at atol 5e-5: AMSGrad's first step moves a parameter by
lr * g / (|g| + eps), so where |g| << eps = 0.01 a gradient difference dg
moves it by lr * dg / eps = 0.01 dg. The float32 gradients of the two
packages differ by up to ~1.3e-3 (the BatchNorm rounding below); measured,
one weight of down1.block.conv.3 ends 1.27e-5 apart, every other one
within 1e-5.

pred, the relu'd affinities of the train-mode forward, is held at atol
2e-3. Measured at these widths: Flax's train-mode BatchNorm takes the
batch variance as E[x^2] - E[x]^2, and its float32 rounding puts the JAX
forward's embedding 2.0e-4 off a float64 run of the same weights, where
the port's is 3.0e-5 off; pred differs between the packages by 2.3e-4 at
step 1 and 6.4e-4 at step 2 (BatchNorm over the 32 values of a 1/16-scale
channel amplifies it). The loss sums over all pixels and agrees to 1e-7.
That the gap is float32 rounding and not a difference of function is
shown in float64: the JAX step run with a float64 Flax model and the
port's step in float64 agree on the losses at rtol 1e-7 and on pred at
atol 1e-4, the JAX model's float32 interpolation weights being what is
left between them (one parameter ends 2.1e-7 apart after rounding both
to float32, by the same lr / eps sensitivity; held at 1e-6).
"""

import copy
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.train.optim import make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import (
    resunet2d_deep_from_flax, train_state_from_flax)
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.train import (
    AMSGrad, TrainState, TrainStep2D, check_train_config, load_checkpoint, train)

from synth import blob_labels

FILTERS = (4, 6, 8, 12, 16)
OFFSETS = multi_offset([1, 3, 5, 9, 27], 4)
RTOL, ATOL = 1e-5, 1e-5
PRED_ATOL = 2e-3
PARAM_ATOL = 5e-5


def _batch(seed):
    rng = np.random.default_rng(seed)
    seg = np.stack([blob_labels(64, 64, grid=3, radius=8, seed=seed + i)
                    for i in range(2)]).astype(np.int32)
    return {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            "ema_image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            "rules": np.array([[1, 0, 1], [0, 1, 1]], np.float32),
            "seg": seg}


def _flax_model(dtype=jnp.float32):
    return FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16, dtype=dtype)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX init and 2 JAX steps (states, pred, metrics after each)."""
    model = _flax_model()
    batches = [_batch(1), _batch(2)]
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False))(batches[0]["image"][:1]))
    tx = make_optimizer(1e-4)
    state = JaxTrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_2d(model, tx, OFFSETS, use_pallas=False,
                                      device_gt=True))
    steps = []
    for b in batches:
        state, pred, metrics = step(state, b)
        steps.append((jax.device_get(state), np.asarray(pred),
                      {k: float(v) for k, v in metrics.items()}))
    return variables, batches, steps


@pytest.fixture(scope="module")
def jax_run_f64(jax_run):
    """The same 2 JAX steps with a float64 Flax model, state and batches."""
    variables, batches, _ = jax_run
    steps = []
    with jax.enable_x64():
        tx = make_optimizer(1e-4)
        v64 = _f64(variables)
        state = JaxTrainState(v64["params"], v64["batch_stats"], tx.init(v64["params"]),
                              jnp.zeros((), jnp.int32))
        step = jax.jit(make_train_step_2d(_flax_model(jnp.float64), tx, OFFSETS,
                                          use_pallas=False, device_gt=True))
        for b in batches:
            state, pred, metrics = step(state, _f64(b))
            steps.append((jax.device_get(state), np.asarray(pred),
                          {k: float(v) for k, v in metrics.items()}))
    return steps


def _port_state(variables):
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    model.load_state_dict(resunet2d_deep_from_flax(variables))
    return TrainState(model, AMSGrad(model.parameters(), lr=1e-4, eps=0.01,
                                     weight_decay=1e-6))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_step(pred, metrics, jax_pred, jax_metrics):
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(pred.numpy(), jax_pred, atol=PRED_ATOL)


def _check_state(model, jax_state):
    exp = resunet2d_deep_from_flax({"params": jax_state.params,
                                    "batch_stats": jax_state.batch_stats})
    got = model.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            atol = ATOL if k.endswith(("running_mean", "running_var")) else PARAM_ATOL
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_train_step_matches_jax_over_two_steps(jax_run, fused):
    variables, batches, steps = jax_run
    state = _port_state(variables)
    step = TrainStep2D(OFFSETS, use_pallas=fused, fuse_loss=fused, device_ema=False)
    for b, (jax_state, jax_pred, jax_metrics) in zip(batches, steps):
        pred, metrics = step(state, _tensors(b))
        _check_step(pred, metrics, jax_pred, jax_metrics)
        _check_state(state.model, jax_state)
    assert state.step == 2


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_train_step_float64_matches_jax_float64(jax_run, jax_run_f64, fused):
    variables, batches, _ = jax_run
    state = _port_state(variables)
    state.model.double()
    state.optimizer = AMSGrad(state.model.parameters(), lr=1e-4, eps=0.01,
                              weight_decay=1e-6)
    step = TrainStep2D(OFFSETS, use_pallas=fused, fuse_loss=fused, device_ema=False)
    for b, (jax_state, jax_pred, jax_metrics) in zip(batches, jax_run_f64):
        pred, metrics = step(state, _tensors(_f64(b)))
        for k, v in jax_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-7, err_msg=k)
        np.testing.assert_allclose(pred.numpy(), jax_pred, atol=1e-4)
        # both states rounded to float32: within one float32 rounding
        exp = resunet2d_deep_from_flax({"params": jax_state.params,
                                        "batch_stats": jax_state.batch_stats})
        got = state.model.state_dict()
        for k, v in exp.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got[k].float().numpy(), v.numpy(), rtol=2e-7,
                                           atol=1e-6, err_msg=k)


def test_train_state_from_flax_continues_the_jax_run(jax_run):
    """The JAX state after step 1 (with its AMSGrad moments) carried across;
    the port's step 2 then matches the JAX step 2."""
    _, batches, steps = jax_run
    state = _port_state({"params": steps[0][0].params,
                         "batch_stats": steps[0][0].batch_stats})
    state.step = train_state_from_flax(steps[0][0], state.model, state.optimizer)
    assert state.step == 1
    assert all(st["count"] == 1 for st in state.optimizer.state.values())
    pred, metrics = TrainStep2D(OFFSETS, device_ema=False)(state, _tensors(batches[1]))
    _check_step(pred, metrics, steps[1][1], steps[1][2])
    _check_state(state.model, steps[1][0])


def test_batchnorm_running_stats_match_flax():
    """Train-mode forward: the running statistics as Flax's
    ``mutable=["batch_stats"]`` gives them (biased batch variance, Flax
    momentum 0.9); torch's stock BatchNorm2d is off by the n/(n-1) factor."""
    model = _flax_model()
    x = _batch(3)["image"]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x[:1], train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * (0.3 if "kernel" in name else 0.1)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    _, mut = jax.jit(lambda v, a: model.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, x)
    exp = resunet2d_deep_from_flax({"params": variables["params"],
                                    "batch_stats": jax.device_get(mut["batch_stats"])})
    port = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    port.load_state_dict(resunet2d_deep_from_flax(variables))
    stock = copy.deepcopy(port)
    for name, mod in stock.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.__class__ = torch.nn.BatchNorm2d
    with torch.no_grad():
        port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        stock.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got, off = port.state_dict(), stock.state_dict()
    gap = 0.0
    for k, v in exp.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            gap = max(gap, float((off[k] - v).abs().max()))
    assert gap > 1e-4


class FixedSample:
    """A training set of one sample: every batch is the same, so a resumed
    run sees the batches an uninterrupted one saw."""

    def __init__(self, sample):
        self.s = sample

    def sample(self, rng):
        return self.s


def _train_setup(tmp_path, name, **train_kw):
    b = _batch(4)
    sample = {"image": b["image"][0], "seg": b["seg"][0]}
    valid = [{"image": b["image"][i], "seg": b["seg"][i]} for i in range(2)]
    cfg = load_config("cvppp", {
        "model": {"filters": FILTERS},
        "train": {"num_workers": 1, "display_freq": 1, "valid_freq": 3,
                  "save_freq": 2, **train_kw},
        "data": {"device_resident": False},  # the host samples above
        "save_path": str(tmp_path / name)})
    return cfg, (FixedSample(sample), valid)


def test_train_on_cpu_validates_checkpoints_and_resumes_exactly(tmp_path):
    cfg, data = _train_setup(tmp_path, "a")
    state, history = train(cfg, max_iters=3, data_override=data, device="cpu")
    assert state.step == 3
    assert len(history) == 1 and history[0]["step"] == 3
    assert all(np.isfinite(v) for v in history[0].values())
    run = os.path.join(cfg.save_path, cfg.name)
    assert sorted(os.listdir(run)) == ["log", "model-000002.ckpt", "model-000003.ckpt"]
    with open(os.path.join(run, "log", "loss.txt")) as f:
        assert len(f.readlines()) == 3
    with open(os.path.join(run, "log", "valid.txt")) as f:
        assert "valid/SBD" in f.read()

    # a second run resumes from step 2's checkpoint and redoes step 3
    cfg_b, _ = _train_setup(tmp_path, "b", resume=True)
    run_b = os.path.join(cfg_b.save_path, cfg_b.name)
    os.makedirs(run_b)
    shutil.copy(os.path.join(run, "model-000002.ckpt"), run_b)
    state_b, _ = train(cfg_b, max_iters=3, data_override=data, device="cpu")
    assert state_b.step == 3
    a = load_checkpoint(os.path.join(run, "model-000003.ckpt"))
    b = load_checkpoint(os.path.join(run_b, "model-000003.ckpt"))
    # the msgpack trees (params, batch_stats, opt_state, step), bit for bit
    la, lb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.array_equal(x, y), jax.tree_util.keystr(p)


# the EMA view's noise and blur, the device-resident sampler, bfloat16
# compute, the schedules, the host-built targets and the ResNet archs are
# ported now: their cases pass the check
PORTED_OPTIONS = [{"data": {"if_ema_noise": True}}, {"data": {"if_ema_blur": True}},
                  {"data": {"device_resident": True}}, {"model": {"dtype": "bfloat16"}},
                  {"train": {"lr_mode": "poly"}}, {"data": {"device_gt": False}},
                  {"model": {"arch": "resnet50_embedding"}}]


@pytest.mark.parametrize("override", [
    {"train": {"lr_mode": "poly"}},
    {"model": {"dtype": "bfloat16"}},
    {"data": {"if_ema_noise": True}},
    {"model": {"arch": "resnet50_embedding"}},
    {"data": {"device_gt": False}},
    {"data": {"if_ema_blur": True}},
    {"data": {"device_resident": True}},
])
def test_unported_train_options_raise(override):
    cfg = load_config("cvppp", override)
    if override in PORTED_OPTIONS:
        check_train_config(cfg)
        return
    with pytest.raises(NotImplementedError):
        check_train_config(cfg)


def test_train_without_data_override_raises(tmp_path):
    """Without the device-resident sampler and without data_override the
    host disk sampler reads data.data_folder: a missing folder raises."""
    missing = str(tmp_path / "no_such_folder")
    with pytest.raises(FileNotFoundError, match="no_such_folder"):
        train(load_config("cvppp", {"data": {"device_resident": False, "data_folder": missing}}),
              max_iters=1, device="cpu")


def test_cvppp_preset_matches_jax():
    port, ref = load_config("cvppp"), jax_load_config("cvppp")
    assert port.name == ref.name and port.save_path == ref.save_path
    n = 0
    for sec in ("model", "train", "data"):
        p, r = getattr(port, sec), getattr(ref, sec)
        for k in vars(p):
            if k == "dtype":  # "auto": float32 in the port, bfloat16 on a TPU
                continue
            # the TPU's 3D serving choices, off by default in the port (the
            # JAX defaults are on; both are served when set)
            if k in ("bf16_tiled_infer", "fast_tiled_infer"):
                assert not getattr(p, k) and getattr(r, k)
                continue
            assert getattr(p, k) == getattr(r, k), f"{sec}.{k}"
            n += 1
    assert n >= 35
