"""The port's data-parallel train steps on the CPU: N gloo ranks against
one process, and against the JAX package's step on its 8-device mesh.

The CVPPP step, the 3D step and the BBBC step with its mask head run at a
global batch of 8 (filters (4, 6, 8, 12, 16); 64x64, or 6x32x32 crops) on
2 and 4 ranks, spawned processes that join a gloo group through a file
(``torch_dp_ranks.py``), and in this process on the whole batch, from the
same weights, over 2 steps:

* float64 (the float32 weights and batches, widened): the N-rank step is
  the one-process step: loss at rtol 1e-12, every all-reduced gradient
  within 1e-10 of its largest element and of the whole gradient's norm,
  the running statistics at 1e-12. Step 2 of BBBC sits at 1e-7: the one
  process sums the mask head's class weights in float32, the ranks take
  the exact 2 n_fg n_bg of their all-reduced counts.
* float32, the dtype the presets train in: the loss at rtol 1e-6, the
  running statistics at atol 1e-6, and the gradients against the float64
  step no farther than twice the one-process float32 step is, plus 1e-4
  for the worst tensor (relative to its largest element) and 1e-5 for the
  whole gradient (relative to its norm), as ``chip_smoke.py`` holds the
  kernels against float64: float32 reassociation alone puts two
  summation orders of the BBBC step up to 2.7e-4 of a tensor's largest
  apart, and the one-process step 1e-3 off float64 (measured here). After 2 steps every
  parameter at ``tests/test_dp_parity.py``'s TOL (AMSGrad's first steps
  move a parameter by about lr sign(g)).
* the parameters and buffers bit-equal across the ranks after each step.
* against JAX's ``make_train_step_2d``/``_3d`` on the conftest's 8-device
  CPU mesh (one sample a device), one step from the same weights: loss,
  parameters and BatchNorm statistics at ``test_dp_parity.py``'s TOL.

The BBBC batch's foreground grows with the sample index, so its shards hold
very different foreground fractions: a per-shard mask-head normaliser
moves the loss by more than 1e-2 (shown on the same batch), where the
ranks' loss holds at 1e-6. The biases of the convolutions in front of a
train-mode BatchNorm have a true gradient of 0; theirs are held against
the largest gradient of the model.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.models.unet3d_pni import UNetPNIEmbeddingDeep as FlaxPNI
from pixel_embedded_affinity_tpu.ops import multi_offset as jax_multi_offset
from pixel_embedded_affinity_tpu.parallel import (batch_sharding, get_mesh,
                                                  replicated_sharding)
from pixel_embedded_affinity_tpu.train.optim import make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d, make_train_step_3d)

from pixel_embedded_affinity_torch.convert import (
    resunet2d_deep_from_flax, train_state_to_flax, unet_pni_deep_from_flax)
from pixel_embedded_affinity_torch.ops.losses import mask_head_loss
from pixel_embedded_affinity_torch.train import AMSGrad

import torch_dp_ranks as R

WORLDS = (2, 4)
DTYPES = ("float32", "float64")
TOL = dict(rtol=3e-3, atol=2.5e-4)  # tests/test_dp_parity.py's
HOLDS = {"float64": dict(loss=1e-12, grad=1e-10, stats=1e-12),
         "float32": dict(loss=1e-6, stats=1e-6)}
# the ranks' float32 gradient error against float64: at most twice the one
# process's, plus float32's own noise (worst tensor, whole gradient)
F32_GRAD_EXCESS, F32_GRAD_FLOOR = 2.0, (1e-4, 1e-5)
BBBC_F64_STEP2_LOSS = 1e-7
ZERO_BIAS = re.compile(r"(conv\.[03]|project\.0|binary_seg\.0)\.bias$|^up\d\.1\.bias$")
STATS = ("running_mean", "running_var")


def _cases():
    cases = {}
    for kind in R.KINDS:
        model = R.make_model(kind)
        batches = [R.make_batch(kind, s) for s in (1, 2)]
        for dt in DTYPES:
            m = model.double() if dt == "float64" else model
            cases[f"{kind}-{dt}"] = {
                "what": "steps", "kind": kind,
                "state_dict": {k: v.clone() for k, v in m.state_dict().items()},
                "batches": [{k: v.astype(dt) if v.dtype == np.float32 else v
                             for k, v in b.items()} for b in batches]}
    return cases


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def launched(cases, tmp_path_factory):
    """The ranks of every world size, started at once: they run while this
    process computes its references."""
    return {w: R.Ranks(w, tmp_path_factory.mktemp(f"dp{w}"), cases) for w in WORLDS}


@pytest.fixture(scope="module")
def one(cases, launched):
    """Every case in this process, on the whole batch."""
    out = {}
    for name, case in cases.items():
        out[name] = R.train_steps(*R.build_case(case))
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, launched, one, jax_meshed):
    world = request.param
    return world, launched[world].results()


def _max_rel(a, b):
    return float((a.double() - b.double()).abs().max())


def _grad_errors(grads, truth) -> tuple:
    """(the worst tensor's max error relative to its largest element, the
    whole gradient's error relative to its norm) of ``grads`` against
    ``truth``; a bias whose true gradient is 0 against the model's largest."""
    assert set(grads) == set(truth)
    top = max(float(g.abs().max()) for g in truth.values())
    worst = max(_max_rel(grads[n], g) / (top if ZERO_BIAS.search(n) else float(g.abs().max()))
                for n, g in truth.items())
    flat = torch.cat([(grads[n].double() - g).reshape(-1) for n, g in truth.items()])
    norm = torch.cat([g.reshape(-1) for g in truth.values()]).norm()
    return worst, float(flat.norm() / norm)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", R.KINDS)
def test_dp_step_matches_one_process(ranks, one, kind, dtype):
    world, res = ranks
    name, hold = f"{kind}-{dtype}", HOLDS[dtype]
    exp, got = one[name], res[0][name]
    for s in range(2):
        for k, v in exp["metrics"][s].items():
            tol = (BBBC_F64_STEP2_LOSS if (kind, dtype, s) == ("bbbc", "float64", 1)
                   else hold["loss"])
            assert abs(got["metrics"][s][k] - v) <= tol * abs(v), (s, k, got["metrics"][s][k], v)
    truth = one[f"{kind}-float64"]["grads"][0]
    dp, ref = _grad_errors(got["grads"][0], truth), _grad_errors(exp["grads"][0], truth)
    if dtype == "float64":
        assert max(dp) <= hold["grad"], dp
    else:
        assert all(d <= F32_GRAD_EXCESS * r + f for d, r, f in zip(dp, ref, F32_GRAD_FLOOR)), (
            dp, ref)
    for k, v in exp["states"][0].items():
        if k.endswith(STATS):
            assert _max_rel(got["states"][0][k], v) <= hold["stats"], k
    for k, v in exp["states"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(got["states"][1][k].double().numpy(),
                                       v.double().numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("kind", R.KINDS)
def test_parameters_stay_equal_across_ranks(ranks, kind):
    world, res = ranks
    for dt in DTYPES:
        for s in range(2):
            ref = res[0][f"{kind}-{dt}"]["states"][s]
            for r in range(1, world):
                other = res[r][f"{kind}-{dt}"]["states"][s]
                assert all(torch.equal(ref[k], other[k]) for k in ref), (dt, s, r)


def test_mask_head_loss_takes_the_global_counts(ranks, one):
    """The BBBC batch's shards differ in foreground; the ranks' loss_mask is
    the one process's, and the mean of per-shard normalised losses is not."""
    world, res = ranks
    exp = one["bbbc-float32"]["metrics"][0]["loss_mask"]
    assert abs(res[0]["bbbc-float32"]["metrics"][0]["loss_mask"] - exp) <= 1e-6 * exp
    batch = R.make_batch("bbbc", 1)
    fg = torch.from_numpy(batch["seg"] > 0)
    shares = fg.reshape(world, -1).float().mean(1)
    assert float(shares.max() - shares.min()) > 0.15, shares
    # logits whose spread grows with the sample, so the classes' mean loss
    # differs between the shards
    scale = torch.arange(1, R.B + 1, dtype=torch.float32)[:, None, None, None]
    logits = torch.from_numpy(np.random.default_rng(3).normal(
        size=fg.shape + (2,)).astype(np.float32)) * scale
    whole = float(mask_head_loss(logits, fg))
    per_shard = np.mean([float(mask_head_loss(lg, f)) for lg, f in
                         zip(logits.chunk(world), fg.chunk(world))])
    assert abs(per_shard - whole) > 1e-2 * whole, (per_shard, whole)


def _jax_setup(kind, sd_model):
    offsets = jax_multi_offset(R.SHIFTS, neighbor=4)
    tx = make_optimizer(1e-4)
    if kind == "3d":
        model = FlaxPNI(filters=R.FILTERS, emd=16)
        step = make_train_step_3d(model, tx, use_pallas=False, device_gt=True)
        to_port = unet_pni_deep_from_flax
    else:
        model = FlaxResUNet(out_channels=2, nfeatures=R.FILTERS, emd=16)
        step = make_train_step_2d(model, tx, offsets, mask_weight=1000.0 if kind == "bbbc"
                                  else 0.0, use_pallas=False, device_gt=True)
        to_port = resunet2d_deep_from_flax
    tree = train_state_to_flax(sd_model, AMSGrad(sd_model.parameters(), lr=1e-4, eps=0.01), 0)
    state = JaxTrainState(tree["params"], tree["batch_stats"], tx.init(tree["params"]),
                          jnp.zeros((), jnp.int32))
    return step, state, to_port


@pytest.fixture(scope="module")
def jax_meshed(cases, launched):
    """JAX's step on the 8-device mesh, one step of each float32 case."""
    devices = jax.devices()
    assert len(devices) == 8  # the virtual CPU mesh of tests/conftest.py
    mesh = get_mesh(devices)
    bsh, rsh = batch_sharding(mesh), replicated_sharding(mesh)
    out = {}
    for kind in R.KINDS:
        case = cases[f"{kind}-float32"]
        model = R.make_model(kind)
        model.load_state_dict(case["state_dict"])
        step, state, to_port = _jax_setup(kind, model)
        batch = case["batches"][0]
        jit_step = jax.jit(step, in_shardings=(rsh, {k: bsh for k in batch}))
        new, _, metrics = jit_step(jax.device_put(state, rsh),
                                   {k: jax.device_put(v, bsh) for k, v in batch.items()})
        new = jax.device_get(new)
        out[kind] = (float(metrics["loss"]),
                     to_port({"params": new.params, "batch_stats": new.batch_stats}))
    return out


@pytest.mark.parametrize("kind", R.KINDS)
def test_dp_step_matches_jax_meshed_step(ranks, jax_meshed, kind):
    world, res = ranks
    loss, exp = jax_meshed[kind]
    got = res[0][f"{kind}-float32"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], loss, **TOL)
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got["states"][0][k].numpy(), v.numpy(), err_msg=k, **TOL)
