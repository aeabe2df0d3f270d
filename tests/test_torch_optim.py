"""The port's learning-rate schedules and optimizers vs the JAX package's.

Schedules: every ``lr_mode`` against JAX's ``make_schedule`` at steps 0, 1,
warmup - 1, warmup, mid-decay, ``decay_iters`` and beyond, at 1e-7
relative (both compute in float32, the port as XLA fuses the jitted
expressions: measured equal to the bit over steps 0..2100). Optimizers:
two updates of the port's AMSGrad (poly schedule) and SGD (fixed and
poly) against the JAX chain on the ResidualUNet2DDeep
parameter tree at filters (4, 6, 8, 12, 16), the same seeded gradients
fed to both; parameters at 5e-5 as ``test_torch_train.py`` holds them
(measured: a few float32 ulps), and the optimizer state read back in
optax's layout (``convert.opt_state_to_flax``) at the same bar.
"""

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
import optax

from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.train import optim as jax_optim

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import (
    opt_state_to_flax, resunet2d_deep_params_from_flax, resunet2d_deep_from_flax)
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.train import optim

FILTERS = (4, 6, 8, 12, 16)
PARAM_ATOL = 5e-5
SCHED = dict(base_lr=1e-3, end_lr=1e-5, total_iters=1000, warmup_iters=20, decay_iters=400,
             power=1.5)


@pytest.mark.parametrize("mode", ["poly", "steplr", "multi_steplr", "explr", "lambdalr"])
def test_schedule_matches_jax(mode):
    kw = dict(SCHED)
    if mode == "steplr":
        kw["step_size"] = 100
    j = jax_optim.make_schedule(mode, **kw)
    p = optim.make_schedule(mode, **kw)
    w, d = SCHED["warmup_iters"], SCHED["decay_iters"]
    steps = [0, 1, w - 1, w, (w + d) // 2, d - 1, d, d + 7, 999, 100000, 150001]
    for s in steps:
        want = float(jax.jit(j)(jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(p(s), want, rtol=1e-7, err_msg=f"{mode} at {s}")


@pytest.mark.parametrize("mode", ["fixed", "cosine"])
def test_fixed_and_cosine_have_no_schedule(mode):
    assert optim.make_schedule(mode, **SCHED) is None
    with pytest.raises(ValueError):
        optim.make_schedule("warmup_cosine", **SCHED)


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32),
                                  shapes)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    # gradients of both sizes against eps = 0.01: AMSGrad's update is
    # g / (|g| + eps)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * rng.choice([1e-3, 1e-1], size=a.shape))
        .astype(np.float32), params)


CASES = {"adam-poly": {"opt_type": "adam", "lr_mode": "poly"},
         "sgd-fixed": {"opt_type": "sgd", "lr_mode": "fixed"},
         "sgd-poly": {"opt_type": "sgd", "lr_mode": "poly"}}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_two_updates_match_the_jax_chain(flax_params, case):
    train = {**CASES[case], "base_lr": 1e-3, "end_lr": 1e-5, "warmup_iters": 1,
             "decay_iters": 10, "power": 1.5}
    tc = load_config("cvppp", {"train": train}).train
    schedule = (None if tc.lr_mode == "fixed" else jax_optim.make_schedule(
        tc.lr_mode, tc.base_lr, tc.end_lr, tc.total_iters, tc.warmup_iters,
        tc.decay_iters, tc.power))
    tx = jax_optim.make_optimizer(tc.base_lr, eps=0.01, weight_decay=tc.weight_decay,
                                  opt_type=tc.opt_type, schedule=schedule)
    params = flax_params["params"]
    opt_state = tx.init(params)

    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    model.load_state_dict(resunet2d_deep_from_flax(flax_params))
    opt = optim.make_optimizer(model.parameters(), tc)
    named = dict(model.named_parameters())
    for seed in (1, 2):
        g = _grads(params, seed)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, t in resunet2d_deep_params_from_flax(g).items():
            named[name].grad = t.clone()
        opt.step()
    assert opt.count == 2
    exp = resunet2d_deep_params_from_flax(jax.device_get(params))
    for name, t in named.items():
        np.testing.assert_allclose(t.detach().numpy(), exp[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)
    # the state in optax's layout
    got = opt_state_to_flax(model, opt)
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(ser.to_state_dict(opt_state)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=1e-5)


def test_unknown_opt_type_raises():
    tc = load_config("cvppp", {"train": {"opt_type": "adamw"}}).train
    with pytest.raises(ValueError, match="opt_type"):
        optim.make_optimizer([torch.zeros(2, requires_grad=True)], tc)


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_optimizer_copies_keep_the_schedule_and_count(opt_type):
    """A deep copy (a train state copied whole, as chip_smoke.py's unfused
    phase copies it) keeps the schedule and the update count."""
    import copy

    tc = load_config("cvppp", {"train": {"opt_type": opt_type, "lr_mode": "poly",
                                         "warmup_iters": 2, "decay_iters": 10}}).train
    p = torch.zeros(3, requires_grad=True)
    opt = optim.make_optimizer([p], tc)
    p.grad = torch.ones(3)
    opt.step()
    twin = copy.deepcopy(opt)
    assert twin.count == 1 and twin.lr(twin.param_groups[0]) == opt.lr(opt.param_groups[0])
    twin.param_groups[0]["params"][0].grad = torch.ones(3)
    twin.step()
    assert twin.count == 2 and opt.count == 1
