"""Train checkpoints that either package resumes, on the CPU.

The port writes the JAX package's msgpack layout of its ``TrainState``,
and reads the JAX package's files. Both directions run the same two CVPPP
steps as ``test_torch_train.py`` (filters (4, 6, 8, 12, 16), 64x64, B=2,
``use_pallas=False``, the EMA view passed in), here with AMSGrad at a
``poly`` schedule so the schedule's count crosses too:

* JAX step 1, JAX ``save_checkpoint``; the port restores the file and runs
  step 2, which matches JAX's step 2 (parameters at 5e-5, losses at 1e-5
  relative, the bars of ``test_torch_train.py``);
* the port runs step 1 from the same Flax init and saves; JAX's
  ``load_checkpoint`` and ``from_state_dict`` take the file (no
  exception, so the JAX loop logs no opt_state warning), and JAX's step 2
  from it matches JAX's uninterrupted step 2 at the same bars;
* the two files' trees have the same keys, shapes and dtypes, for
  AMSGrad (fixed and poly, with and without weight decay) and SGD.

An earlier port run's ``torch.save`` file still restores, and a state that
does not fit the configured chain falls back to a fresh optimizer with
the JAX loop's warning.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import flax.serialization as ser
import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.train import checkpoint as jax_ckpt
from pixel_embedded_affinity_tpu.train.optim import make_optimizer as jax_make_optimizer
from pixel_embedded_affinity_tpu.train.optim import make_schedule as jax_make_schedule
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import load_flax_variables, resunet2d_deep_from_flax
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.train import (
    TrainState, TrainStep2D, load_checkpoint, make_optimizer, restore, save_checkpoint)

from synth import blob_labels

FILTERS = (4, 6, 8, 12, 16)
OFFSETS = multi_offset([1, 3, 5, 9, 27], 4)
RTOL, ATOL, PARAM_ATOL = 1e-5, 1e-5, 5e-5
TRAIN = {"lr_mode": "poly", "base_lr": 1e-4, "end_lr": 1e-6, "warmup_iters": 1,
         "decay_iters": 10, "power": 1.5}


def _batch(seed):
    rng = np.random.default_rng(seed)
    seg = np.stack([blob_labels(64, 64, grid=3, radius=8, seed=seed + i)
                    for i in range(2)]).astype(np.int32)
    return {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            "ema_image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            "rules": np.array([[1, 0, 1], [0, 1, 1]], np.float32), "seg": seg}


def _cfg(**train):
    return load_config("cvppp", {"model": {"filters": FILTERS}, "train": {**TRAIN, **train}})


def _jax_tx(tc):
    sched = None if tc.lr_mode in ("fixed", "cosine") else jax_make_schedule(
        tc.lr_mode, tc.base_lr, tc.end_lr, tc.total_iters, tc.warmup_iters, tc.decay_iters,
        tc.power)
    return jax_make_optimizer(tc.base_lr, eps=0.01, weight_decay=tc.weight_decay or 0.0,
                              opt_type=tc.opt_type, schedule=sched)


@pytest.fixture(scope="module")
def jax_run():
    """Flax init, JAX steps 1 and 2 (state after each, metrics)."""
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16)
    batches = [_batch(1), _batch(2)]
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False))(batches[0]["image"][:1]))
    tx = _jax_tx(_cfg().train)
    state = JaxTrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_2d(model, tx, OFFSETS, use_pallas=False, device_gt=True))
    steps = []
    for b in batches:
        state, _, metrics = step(state, b)
        steps.append((jax.device_get(state), {k: float(v) for k, v in metrics.items()}))
    return variables, batches, steps, step, tx


def _port_state(variables, cfg):
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    load_flax_variables(model, variables)
    return TrainState(model, make_optimizer(model.parameters(), cfg.train))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_params(model, jax_state):
    exp = resunet2d_deep_from_flax({"params": jax_state.params,
                                    "batch_stats": jax_state.batch_stats})
    got = model.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            atol = ATOL if k.endswith(("running_mean", "running_var")) else PARAM_ATOL
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)


def _tree_layout(tree):
    """(key path, shape, dtype) of every leaf."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return sorted((jax.tree_util.keystr(p), np.shape(v), np.asarray(v).dtype.str)
                  for p, v in leaves)


def test_port_resumes_a_jax_checkpoint(jax_run, tmp_path):
    variables, batches, steps, _, _ = jax_run
    fname = jax_ckpt.save_checkpoint(str(tmp_path), steps[0][0], 1)
    cfg = _cfg()
    state = restore(_port_state(variables, cfg), load_checkpoint(fname))
    assert state.step == 1 and state.optimizer.count == 1
    lr = state.optimizer.lr(state.optimizer.param_groups[0])
    assert lr == float(jax_make_schedule("poly", 1e-4, 1e-6, cfg.train.total_iters, 1, 10,
                                         1.5)(1))
    _, metrics = TrainStep2D(OFFSETS, use_pallas=False, device_ema=False)(
        state, _tensors(batches[1]))
    for k, v in steps[1][1].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
    _check_params(state.model, steps[1][0])


def test_jax_resumes_a_port_checkpoint(jax_run, tmp_path):
    variables, batches, steps, jax_step, tx = jax_run
    state = _port_state(variables, _cfg())
    TrainStep2D(OFFSETS, use_pallas=False, device_ema=False)(state, _tensors(batches[0]))
    fname = save_checkpoint(str(tmp_path), state, 1)
    with open(fname, "rb") as f:
        assert f.read(1)[0] & 0xF0 == 0x80  # a msgpack map, not a zip archive
    restored = jax_ckpt.load_checkpoint(fname)
    fresh = tx.init(variables["params"])
    opt_state = ser.from_state_dict(fresh, restored["opt_state"])
    assert int(opt_state[2].count) == 1 and int(opt_state[1].count) == 1
    params = ser.from_state_dict(variables["params"], restored["params"])
    stats = ser.from_state_dict(variables["batch_stats"], restored["batch_stats"])
    jstate = JaxTrainState(params, stats, opt_state, restored["step"])
    jstate, _, metrics = jax_step(jstate, batches[1])
    for k, v in steps[1][1].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL, err_msg=k)
    exp = resunet2d_deep_from_flax({"params": steps[1][0].params,
                                    "batch_stats": steps[1][0].batch_stats})
    got = resunet2d_deep_from_flax(jax.device_get({"params": jstate.params,
                                                   "batch_stats": jstate.batch_stats}))
    for k, v in exp.items():
        atol = ATOL if k.endswith(("running_mean", "running_var")) else PARAM_ATOL
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("train", [{}, {"lr_mode": "fixed"}, {"weight_decay": 0.0},
                                   {"opt_type": "sgd"}, {"opt_type": "sgd", "lr_mode": "fixed"}],
                         ids=["adam-poly", "adam-fixed", "adam-no-decay", "sgd-poly",
                              "sgd-fixed"])
def test_both_packages_write_one_tree(jax_run, tmp_path, train):
    variables, batches, _, _, _ = jax_run
    cfg = _cfg(**train)
    tx = _jax_tx(cfg.train)
    jstate = JaxTrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    jfile = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 0)
    state = _port_state(variables, cfg)
    pfile = save_checkpoint(str(tmp_path / "port"), state, 0)
    a, b = jax_ckpt.load_checkpoint(jfile), jax_ckpt.load_checkpoint(pfile)
    assert _tree_layout(a) == _tree_layout(b)
    # a fresh state is the same file, byte for byte
    with open(jfile, "rb") as f, open(pfile, "rb") as g:
        assert f.read() == g.read()


def test_an_earlier_torch_save_checkpoint_still_restores(jax_run, tmp_path):
    variables, batches, _, _, _ = jax_run
    cfg = _cfg(lr_mode="fixed")
    state = _port_state(variables, cfg)
    TrainStep2D(OFFSETS, use_pallas=False, device_ema=False)(state, _tensors(batches[0]))
    old = tmp_path / "model-000001.ckpt"
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": 1}, old)
    back = restore(_port_state(variables, cfg), load_checkpoint(str(old)))
    assert back.step == 1 and back.optimizer.count == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, back.model.state_dict()[k]), k
    for p, q in zip(state.model.parameters(), back.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            w = back.optimizer.state[q][k]
            assert (torch.equal(v, w) if torch.is_tensor(v) else v == w), k


def test_a_state_off_the_chain_resumes_with_a_fresh_optimizer(jax_run, tmp_path, caplog):
    variables, batches, _, _, _ = jax_run
    state = _port_state(variables, _cfg())
    TrainStep2D(OFFSETS, use_pallas=False, device_ema=False)(state, _tensors(batches[0]))
    fname = save_checkpoint(str(tmp_path), state, 1)
    sgd = _port_state(variables, _cfg(opt_type="sgd"))
    with caplog.at_level(logging.WARNING, logger="pea"):
        restore(sgd, load_checkpoint(fname))
    assert "opt_state incompatible" in caplog.text
    assert sgd.step == 1 and sgd.optimizer.count == 0 and not sgd.optimizer.state
    for k, v in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sgd.model.state_dict()[k]), k
    assert os.path.basename(fname) == "model-000001.ckpt"
