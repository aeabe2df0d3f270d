"""The port's AC3/AC4 train step and loop vs the JAX package's, on the CPU.

The whole step is held against the JAX package's ``make_train_step_3d``
(``use_pallas=False``, ``device_gt=True``, the EMA view and its rules
passed in) over 2 steps from the same Flax weights carried across, at
filters (4, 6, 8, 12, 16), B=2 crops of 6x32x32; the port runs it through
its kernels' wrappers (their plain versions on the CPU) and through its
plain path. Tolerances, each a few times the gap measured at these
widths (the float32 math of the two packages in another order, Flax's
train-mode BatchNorm taking the batch variance as E[x^2] - E[x]^2):

* losses at rtol 2e-6 (measured 6.3e-7 apart): sums over every voxel;
* BatchNorm statistics at atol 2e-6 (3.6e-7);
* parameters at atol 2e-6 (2.7e-7): AMSGrad moves a parameter by
  lr * g / (|g| + eps), so where |g| << eps = 0.01 a gradient difference
  dg moves it by 0.01 dg;
* pred, relu of the train-mode self affinities, at atol 5e-4 (1.2e-4):
  the forwards differ by the BatchNorm rounding, and an affinity is a dot
  of two normalised 16-vectors.
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

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.models.unet3d_pni import UNetPNIEmbeddingDeep as FlaxPNI
from pixel_embedded_affinity_tpu.train.optim import make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_3d)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import train_state_from_flax, unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.data import AC3AC4ValidVolume, synthesize_volume
from pixel_embedded_affinity_torch.data.ac3ac4 import convert_consistency_flip_3d_rule4
from pixel_embedded_affinity_torch.data.device_aug import flip_3d_rule4
from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.ops import (
    affinity_bwd, cross_affinity_bwd, cross_affinity_fwd, fused_affinity_3d)
from pixel_embedded_affinity_torch.train import (
    AMSGrad, TrainState, TrainStep3D, check_train_config, load_checkpoint, train)
from pixel_embedded_affinity_torch.train.train_step import _bdhwc, _ncdhw

from synth import tile_labels_3d

FILTERS = (4, 6, 8, 12, 16)
CROP = (6, 32, 32)
RTOL, ATOL = 2e-6, 2e-6
PRED_ATOL = 5e-4
PARAM_ATOL = 2e-6
RULES = np.array([[1, 0, 1, 1], [0, 1, 0, 1]], np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    seg = np.stack([tile_labels_3d(*CROP, 2, 3, 3) + 10 * i for i in range(2)])
    seg[rng.random(seg.shape) < 0.1] = 0
    shape = (2,) + CROP + (1,)
    return {"image": rng.random(shape).astype(np.float32),
            "ema_image": rng.random(shape).astype(np.float32),
            "rules": RULES, "seg": seg.astype(np.int32)}


def _flax_variables(model, x):
    """Flax weights drawn with numpy (no jitted init): kernels at
    1/sqrt(fan in), BatchNorm scale 1 + N(0, 0.1), biases N(0, 0.1), the
    statistics at their init."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "'mean'" in name:
            return np.zeros(leaf.shape, np.float32)
        if "'var'" in name:
            return np.ones(leaf.shape, np.float32)
        base = 1.0 if "'scale'" in name else 0.0
        return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_run():
    """Flax weights and 2 JAX steps (states, pred, metrics after each)."""
    model = FlaxPNI(filters=FILTERS, emd=16)
    batches = [_batch(1), _batch(2)]
    variables = _flax_variables(model, batches[0]["image"][:1])
    tx = make_optimizer(1e-4)
    state = JaxTrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_3d(model, tx, use_pallas=False, device_gt=True))
    steps = []
    for b in batches:
        state, pred, metrics = step(state, b)
        steps.append((jax.device_get(state), np.asarray(pred),
                      {k: float(v) for k, v in metrics.items()}))
    return variables, batches, steps


def _port_state(variables):
    model = UNetPNIEmbeddingDeep(1, FILTERS, 16)
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    return TrainState(model, AMSGrad(model.parameters(), lr=1e-4, eps=0.01,
                                     weight_decay=1e-6))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_step(pred, metrics, jax_pred, jax_metrics):
    assert set(metrics) == set(jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
    assert pred.shape == jax_pred.shape == (2, 12) + CROP
    np.testing.assert_allclose(pred.numpy(), jax_pred, atol=PRED_ATOL)


def _check_state(model, jax_state):
    exp = unet_pni_deep_from_flax({"params": jax_state.params,
                                   "batch_stats": jax_state.batch_stats})
    got = model.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            atol = ATOL if k.endswith(("running_mean", "running_var")) else PARAM_ATOL
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)


def _launches():
    return (fused_affinity_3d.launches, affinity_bwd.launches, cross_affinity_fwd.launches,
            cross_affinity_bwd.launches)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_train_step_3d_matches_jax_over_two_steps(jax_run, kernels):
    variables, batches, steps = jax_run
    state = _port_state(variables)
    step = TrainStep3D(use_pallas=kernels, device_ema=False)
    before = _launches()
    for b, (jax_state, jax_pred, jax_metrics) in zip(batches, steps):
        pred, metrics = step(state, _tensors(b))
        _check_step(pred, metrics, jax_pred, jax_metrics)
        _check_state(state.model, jax_state)
    assert state.step == 2
    assert _launches() == before  # the CPU runs the plain versions


def test_train_state_from_flax_continues_the_jax_run_3d(jax_run):
    """The JAX state after step 1 (with its AMSGrad moments) carried into
    the PNI model; the port's step 2 then matches the JAX step 2."""
    _, batches, steps = jax_run
    state = _port_state({"params": steps[0][0].params,
                         "batch_stats": steps[0][0].batch_stats})
    state.step = train_state_from_flax(steps[0][0], state.model, state.optimizer)
    assert state.step == 1
    assert all(st["count"] == 1 for st in state.optimizer.state.values())
    pred, metrics = TrainStep3D(device_ema=False)(state, _tensors(batches[1]))
    _check_step(pred, metrics, steps[1][1], steps[1][2])
    _check_state(state.model, steps[1][0])


def test_embedding_mode_1_trains_with_norm1_at_full_scale(jax_run):
    """embedding_mode=1: the full-scale self and cross losses are norm1's,
    as the JAX step computes them; one step against the JAX step."""
    variables, batches, _ = jax_run
    model = FlaxPNI(filters=FILTERS, emd=16)
    tx = make_optimizer(1e-4)
    jstate = JaxTrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    jstate, jpred, jm = jax.jit(make_train_step_3d(
        model, tx, embedding_mode=1, use_pallas=False, device_gt=True))(jstate, batches[0])
    state = _port_state(variables)
    pred, metrics = TrainStep3D(embedding_mode=1, device_ema=False)(state, _tensors(batches[0]))
    assert pred.shape == (2, 3) + CROP
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=PRED_ATOL)
    _check_state(state.model, jax.device_get(jstate))


class FixedSample:
    """A training set of one crop: every batch is the same, so a resumed
    run sees the batches an uninterrupted one saw."""

    def __init__(self, sample):
        self.s = sample

    def sample(self, rng):
        return self.s


def _train_setup(tmp_path, name, **train_kw):
    raw, label = synthesize_volume(12, 64, 64, n_cells=10, seed=1)
    d, h, w = CROP
    sample = {"image": (raw[:d, :h, :w].astype(np.float32) / 255.0)[..., None],
              "seg": label[:d, :h, :w]}
    valid = AC3AC4ValidVolume("", arrays=synthesize_volume(10, 64, 64, n_cells=8, seed=2))
    cfg = load_config("ac3ac4", {
        "model": {"filters": FILTERS},
        "train": {"num_workers": 1, "display_freq": 1, "valid_freq": 3, "save_freq": 2,
                  **train_kw},
        "data": {"crop_size": (8, 32, 32), "device_resident": False},  # the host sample
        "save_path": str(tmp_path / name)})
    return cfg, (FixedSample(sample), valid)


def test_train_3d_on_cpu_validates_checkpoints_and_resumes_exactly(tmp_path):
    cfg, data = _train_setup(tmp_path, "a")
    timing: dict = {}
    state, history = train(cfg, max_iters=3, data_override=data, device="cpu", timing=timing)
    assert state.step == 3 and isinstance(state.model, UNetPNIEmbeddingDeep)
    assert len(history) == 1 and history[0]["step"] == 3
    m = history[0]
    assert {"valid/waterz_voi", "valid/waterz_arand", "valid/affs_mse",
            "valid/affs_bce"} <= set(m)
    assert all(np.isfinite(v) for v in m.values())
    assert len(timing["step_s"]) == 3 and len(timing["valid_s"]) == 1
    run = os.path.join(cfg.save_path, cfg.name)
    assert sorted(os.listdir(run)) == ["log", "model-000002.ckpt", "model-000003.ckpt"]
    with open(os.path.join(run, "log", "valid.txt")) as f:
        assert "valid/waterz_voi" in f.read()

    # a second run resumes from step 2's checkpoint and redoes step 3
    cfg_b, _ = _train_setup(tmp_path, "b", resume=True, if_valid=False)
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


def test_step_inputs_give_student_and_teacher_one_layout():
    """The step hands the model its (B, D, H, W, 1) image and the EMA view,
    whose flip leaves other strides, with standard NCDHW strides, so the
    student's and the un-flipped teacher's embeddings share one layout (the
    cross kernels read both alike)."""
    img = torch.from_numpy(np.random.default_rng(6).random((2,) + CROP + (1,), np.float32))
    rules = torch.tensor([[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 0.0, 0.0]])
    ema = flip_3d_rule4(img, rules)
    for x in (img, ema):
        t = _ncdhw(x)
        assert t.stride() == torch.empty(t.shape).stride()
        assert torch.equal(t, x.permute(0, 4, 1, 2, 3))
    model = UNetPNIEmbeddingDeep(1, FILTERS, 16).eval()
    with torch.no_grad():
        student = _bdhwc(model(_ncdhw(img))[4])
        teacher = convert_consistency_flip_3d_rule4(_bdhwc(model(_ncdhw(ema))[4]), rules)
    assert teacher.stride() == student.stride()


@pytest.mark.parametrize("override", [
    {"model": {"dtype": "bfloat16"}},
    {"train": {"lr_mode": "poly"}},
    {"data": {"device_ema": False}},
    {"data": {"device_resident": True}},
])
def test_unported_3d_train_options_raise(override):
    cfg = load_config("ac3ac4", override)
    # ported (the device-resident sampler, bfloat16 compute, the schedules,
    # the host EMA view): the check passes
    if override in ({"data": {"device_resident": True}}, {"model": {"dtype": "bfloat16"}},
                    {"train": {"lr_mode": "poly"}}, {"data": {"device_ema": False}}):
        check_train_config(cfg)
        return
    with pytest.raises(NotImplementedError):
        check_train_config(cfg)
