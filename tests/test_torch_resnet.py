"""The port's ResNet-50/101 embedding nets, the discriminative loss and the
``loss_mode="discriminative"`` 2D step against the JAX package's, on the
CPU: ``ResNetEmbedding`` in eval and train mode (outputs and the updated
BatchNorm statistics) at 32x32, the smallest input its stride-16 encoder
and decoder take; ``LocalAttentionBlock`` alone; ``discriminative_loss`` and
its gradient, with an image of one instance; one train step with the
discriminative term on the small ``resunet2d_deep`` the other step tests
use (the term does not depend on the arch); the two presets. Weights are
drawn from a seeded numpy generator in the Flax tree and carried across by
``resnet_embedding_from_flax``.
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

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.models.resnet_embed import (
    LocalAttentionBlock as FlaxLocalAttention, ResNetEmbedding as FlaxResNet)
from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
from pixel_embedded_affinity_tpu.ops.losses_extra import (
    discriminative_loss as jax_discriminative_loss)
from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model
from pixel_embedded_affinity_tpu.train.optim import make_optimizer
from pixel_embedded_affinity_tpu.train.train_step import (
    TrainState as JaxTrainState, make_train_step_2d)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import (
    load_flax_variables, resnet_embedding_from_flax, resunet2d_deep_from_flax,
    train_state_to_flax)
from pixel_embedded_affinity_torch.infer import build_model, forward_affinities
from pixel_embedded_affinity_torch.models import (
    LocalAttentionBlock, ResidualUNet2DDeep, ResNetEmbedding)
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.ops.losses_extra import discriminative_loss
from pixel_embedded_affinity_torch.train import (
    AMSGrad, TrainState, TrainStep2D, check_train_config, make_train_step)

from synth import blob_labels

SIDE = 32
# measured: eval-mode outputs agree to ~1e-6 of their largest value; in
# train mode Flax's BatchNorm takes the variance as E[x^2] - E[x]^2, whose
# float32 rounding grows where a 1/16-scale channel has 8 values
# (ROADMAP.md, faults section, item 7); both held relative to the output's
# largest value. Measured in train mode, relative to each tensor's largest
# value: the packages' outputs 1.5e-4-4.4e-4 apart, each as far from a
# float64 run of the port (JAX 1.3e-4-4.0e-4, the port 1.1e-4-3.9e-4);
# the running statistics 7.9e-5 apart, JAX 7.2e-5 and the port 5.8e-5 off
# float64: float32 rounding on both sides, not a difference of function
EVAL_RTOL = 1e-4
TRAIN_RTOL = 2e-3
STATS_RTOL = 3e-4


def _draw(shapes, seed):
    """Every leaf from a seeded numpy generator: kernels at 1/sqrt(fan-in),
    BatchNorm scales near 1, variances in [0.5, 1.5], the rest spread by 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        if "kernel" in name:
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(
                np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _rel_close(got, exp, rtol, what):
    err = np.abs(np.asarray(got) - np.asarray(exp)).max()
    scale = max(np.abs(np.asarray(exp)).max(), 1e-6)
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def resnet50():
    model = FlaxResNet(depth=50, emd=16, out_channels=2)
    x = np.random.default_rng(0).normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
    variables = _draw(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), train=False)), 1)
    ours = ResNetEmbedding(50)
    ours.load_state_dict(resnet_embedding_from_flax(variables))  # strict
    return model, variables, x, ours


def test_resnet50_eval_matches_jax(resnet50):
    model, variables, x, ours = resnet50
    jouts = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    with torch.no_grad():
        outs = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(outs) == len(jouts) == 6
    sides = (SIDE // 16, SIDE // 8, SIDE // 4, SIDE // 2, SIDE, SIDE)
    for i, (o, j) in enumerate(zip(outs, jouts)):
        o = o.permute(0, 2, 3, 1).numpy()
        assert o.shape == j.shape and o.shape[1] == sides[i]
        _rel_close(o, j, EVAL_RTOL, f"out {i}")


def test_resnet50_train_mode_matches_jax(resnet50):
    """Train mode: the outputs under the batch's statistics and every
    BatchNorm's updated running statistics (Flax momentum 0.9, biased
    variance)."""
    model, variables, x, ours = resnet50
    jouts, mut = jax.jit(lambda v, a: model.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, x)
    ours = ResNetEmbedding(50)
    ours.load_state_dict(resnet_embedding_from_flax(variables))
    with torch.no_grad():
        outs = ours.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (o, j) in enumerate(zip(outs, jouts)):
        _rel_close(o.permute(0, 2, 3, 1).numpy(), j, TRAIN_RTOL, f"out {i}")
    exp = resnet_embedding_from_flax({"params": variables["params"],
                                      "batch_stats": jax.device_get(mut["batch_stats"])})
    got = ours.state_dict()
    n = 0
    for k, v in exp.items():
        if k.endswith(("running_mean", "running_var")):
            _rel_close(got[k].numpy(), v.numpy(), STATS_RTOL, k)
            n += 1
    assert n == 2 * 58  # the stem, 52 in the bottlenecks, 4 in the decoder, the mask head


def test_resnet101_eval_matches_jax():
    model = FlaxResNet(depth=101, emd=16, out_channels=2)
    x = np.random.default_rng(3).normal(size=(1, SIDE, SIDE, 3)).astype(np.float32)
    variables = _draw(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), train=False)), 4)
    jouts = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    ours = ResNetEmbedding(101)
    ours.load_state_dict(resnet_embedding_from_flax(variables, depth=101))
    assert sum(1 for k in ours.state_dict() if k.startswith("layer3_")) == 23 * 18 + 6
    with torch.no_grad():
        outs = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (o, j) in enumerate(zip(outs, jouts)):
        _rel_close(o.permute(0, 2, 3, 1).numpy(), j, EVAL_RTOL, f"out {i}")


@pytest.mark.parametrize("train", [False, True])
def test_local_attention_block_matches_jax(train):
    block = FlaxLocalAttention(32, heads=4, window=8)
    x = np.random.default_rng(5).normal(size=(2, 16, 24, 48)).astype(np.float32)
    variables = _draw(jax.eval_shape(lambda: block.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 24, 48)), train=False)), 6)
    exp = jax.jit(lambda v, a: block.apply(v, a, train=train, mutable=["batch_stats"])[0])(
        variables, x)
    ours = LocalAttentionBlock(48, 32, heads=4, window=8)
    load_flax_variables(ours, variables)
    ours.train(train)
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _rel_close(got, exp, TRAIN_RTOL if train else EVAL_RTOL, "attention")
    with pytest.raises(ValueError, match="window"):
        ours(torch.zeros(1, 48, 12, 16))


def test_resnet_with_local_attention_loads_jax_tree():
    model = FlaxResNet(depth=50, local_attention=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    sd = resnet_embedding_from_flax(_draw(shapes, 7), local_attention=True)
    ours = ResNetEmbedding(50, local_attention=True)
    ours.load_state_dict(sd)
    assert "layer4_attn.qkv.weight" in sd


def _disc_case(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(3, 20, 24, 8)).astype(np.float32)
    seg = np.stack([blob_labels(20, 24, grid=3, radius=5, seed=seed),
                    np.zeros((20, 24), np.int64),        # one instance: background
                    np.where(rng.random((20, 24)) < 0.5, 7, 70)]).astype(np.int32)
    return emb, seg


@pytest.mark.parametrize("include_background", [True, False])
def test_discriminative_loss_and_gradient_match_jax(include_background):
    emb, seg = _disc_case(8)
    kw = dict(include_background=include_background)
    exp, jgrad = jax.value_and_grad(lambda e: jax_discriminative_loss(e, seg, **kw))(emb)
    e = torch.from_numpy(emb).requires_grad_()
    got = discriminative_loss(e, torch.from_numpy(seg), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-5)
    assert torch.isfinite(e.grad).all()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    # a strided view (the step hands the model's NCHW output permuted)
    view = torch.from_numpy(np.ascontiguousarray(emb.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    np.testing.assert_allclose(float(discriminative_loss(view, torch.from_numpy(seg), **kw)),
                               float(exp), rtol=1e-5)


def test_discriminative_loss_of_one_instance_has_finite_gradient():
    """Every image one instance (no pair to push apart, and centroids of
    labels that are absent): the loss is the pull and reg terms alone and
    its gradient stays finite, as the epsilon guards keep JAX's."""
    emb = np.random.default_rng(9).normal(size=(2, 8, 8, 4)).astype(np.float32)
    seg = np.ones((2, 8, 8), np.int32) * 3
    e = torch.from_numpy(emb).requires_grad_()
    got = discriminative_loss(e, torch.from_numpy(seg))
    got.backward()
    exp, jgrad = jax.value_and_grad(lambda x: jax_discriminative_loss(x, seg))(emb)
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-5)
    assert torch.isfinite(e.grad).all()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrad), atol=1e-6)


FILTERS = (4, 6, 8, 12, 16)
OFFSETS = multi_offset([1, 3, 5, 9, 27], 4)


def test_discriminative_train_step_matches_jax():
    """One 2D step with loss_mode="discriminative" (disc_weight 0.5) on the
    small resunet2d_deep, against make_train_step_2d: the losses, loss_disc
    among them, and the updated parameters and statistics."""
    rng = np.random.default_rng(1)
    seg = np.stack([blob_labels(64, 64, grid=3, radius=8, seed=1 + i)
                    for i in range(2)]).astype(np.int32)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "ema_image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "rules": np.array([[1, 0, 1], [0, 1, 1]], np.float32), "seg": seg}
    model = FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16)
    variables = jax.device_get(jax.jit(lambda x: model.init(
        jax.random.PRNGKey(0), x, train=False))(batch["image"][:1]))
    tx = make_optimizer(1e-4)
    state = JaxTrainState(variables["params"], variables["batch_stats"],
                          tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step_2d(model, tx, OFFSETS, use_pallas=False, device_gt=True,
                                      loss_mode="discriminative", disc_weight=0.5))
    jstate, _, jmetrics = step(state, batch)

    ours = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    ours.load_state_dict(resunet2d_deep_from_flax(variables))
    pstate = TrainState(ours, AMSGrad(ours.parameters(), lr=1e-4, eps=0.01, weight_decay=1e-6))
    fn = TrainStep2D(OFFSETS, use_pallas=False, device_gt=True, device_ema=False,
                     loss_mode="discriminative", disc_weight=0.5)
    _, metrics = fn(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(metrics) == set(jmetrics) and "loss_disc" in metrics
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    exp = resunet2d_deep_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = ours.state_dict()
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", ["cvppp_resnet50", "cvppp_resnet101"])
def test_resnet_presets_match_jax(name):
    port, ref = load_config(name), jax_load_config(name)
    assert port.name == ref.name and port.save_path == ref.save_path
    n = 0
    for sec in ("model", "train", "data"):
        p, r = getattr(port, sec), getattr(ref, sec)
        for k in vars(p):
            # float32 serving and the dense 3D module by default in the port
            if k in ("dtype", "bf16_tiled_infer", "fast_tiled_infer"):
                continue
            assert getattr(p, k) == getattr(r, k), f"{sec}.{k}"
            n += 1
    assert n >= 45
    assert port.train.loss_mode == "discriminative" and port.model.arch.startswith("resnet")
    check_train_config(port)
    step = make_train_step(port)
    assert step.loss_mode == "discriminative" and step.disc_weight == 1.0
    model = build_model(port, device="cpu")
    jmodel = jax_build_model(ref)
    assert isinstance(model, ResNetEmbedding) and jmodel.depth == (50 if "50" in name else 101)
    assert len(model.stages[2]) == (6 if "50" in name else 23)


def test_resnet_serves_and_checkpoints_in_the_jax_tree():
    """The arch serves 2D through the dense module and K1f's plain version
    here, and its train checkpoint is the JAX model's tree."""
    cfg = load_config("cvppp_resnet50")
    model = build_model(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 3, SIDE, SIDE)).astype(
        np.float32))
    affs = forward_affinities(model, x, OFFSETS)
    assert affs.shape == (1, len(OFFSETS), SIDE, SIDE) and torch.isfinite(affs).all()
    tree = train_state_to_flax(model, AMSGrad(model.parameters(), lr=1e-4, eps=0.01,
                                              weight_decay=1e-6), 0)
    shapes = jax.eval_shape(lambda: FlaxResNet(depth=50).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), train=False))
    for part in ("params", "batch_stats"):
        exp = jax.tree_util.tree_flatten_with_path(shapes[part])[0]
        got = dict(jax.tree_util.tree_flatten_with_path(tree[part])[0])
        assert len(got) == len(exp)
        for path, leaf in exp:
            assert got[path].shape == leaf.shape, jax.tree_util.keystr(path)
