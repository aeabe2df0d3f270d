"""The port's unfused 2D loss path vs the JAX package's, on the CPU.

* K4f (``fused_cross_affinity_2d``): its plain function, which the CUDA
  wrapper runs on CPU tensors, against ``jax.vjp`` of the Pallas kernel
  in interpret mode, values at atol 1e-6 and gradients at 1e-5 (f32 dots
  in another order, then the normalisation's VJP; a zero vector's pixel
  at 1e-5 of its own largest), on the main path's
  offsets and on neighbor 8's (whose diagonals look right, ox > 0), with
  the teacher given as the view the train step hands it: x and y strides
  swapped, as the un-flip's ``torch.where`` leaves them.
* The BCE criteria and the unfused losses with them against the JAX
  functions: values rtol 1e-5, gradients atol 1e-5 (the losses' also rtol
  1e-3, for BCE's 1/p; see the test).
* The unfused step against the fused one on one batch: the same loss and
  gradients within float32 rounding (the JAX suite ties its two paths in
  ``tests/test_emb2aff_pallas.py::test_fused_wmse_*``), and the unfused
  step routes its affinities through K1 (five scales) and K4 (once).
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

from pixel_embedded_affinity_tpu.ops import losses as JL
from pixel_embedded_affinity_tpu.ops.emb2aff_pallas import (
    fused_cross_affinity_2d as jax_fused_cross_affinity_2d)

from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.ops import (
    cross_affinity_2d_plain, fused_cross_affinity_2d, multi_offset)
from pixel_embedded_affinity_torch.ops import losses as L
from pixel_embedded_affinity_torch.train import TrainStep2D

from synth import blob_labels

T = torch.from_numpy

# (embedding shape, shifts, neighbor): the bbbc039v1 offsets, and neighbor
# 8 on an odd shape
K4_CASES = [((2, 37, 29, 16), [1, 3, 5, 9, 11], 4), ((1, 40, 36, 8), [1, 3], 8)]


def _teacher_view(b_bhwc: np.ndarray) -> torch.Tensor:
    """The same values as a (B, H, W, C) view whose H stride is 1 and W
    stride H: the un-flipped teacher's layout."""
    storage = np.ascontiguousarray(np.transpose(b_bhwc, (0, 3, 2, 1)))  # (B, C, W, H)
    view = T(storage).permute(0, 3, 2, 1)
    assert view.stride()[1] == 1 and view.stride()[2] == b_bhwc.shape[1]
    return view


@pytest.mark.parametrize("idx", range(len(K4_CASES)))
def test_k4f_plain_matches_pallas_interpret(idx):
    shape, shifts, neighbor = K4_CASES[idx]
    rng = np.random.default_rng(40 + idx)
    offsets = multi_offset(shifts, neighbor)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    a[0, 3, 5] = 0.0  # a zero vector: zero affinities, finite gradients
    g = rng.normal(size=(shape[0], len(offsets)) + shape[1:3]).astype(np.float32)
    exp, vjp = jax.vjp(lambda x, y: jax_fused_cross_affinity_2d(
        x, y, tuple(map(tuple, offsets)), 32, True), jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(g))

    ta = T(a).requires_grad_()
    tb = _teacher_view(b).requires_grad_()
    before = fused_cross_affinity_2d.launches
    got = fused_cross_affinity_2d(ta, tb, offsets)
    assert fused_cross_affinity_2d.launches == before  # the CPU runs the plain version
    assert got.shape == (shape[0], len(offsets)) + shape[1:3]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), atol=1e-6)
    assert np.all(got.detach().numpy()[0, :, 3, 5] == 0)
    (got * T(g)).sum().backward()
    # the zero vector's pixel apart: its gradient is the others' times 1e12
    # (the normalisation's VJP divides by the clamped norm), held relative
    # to its own largest
    da, zero = ta.grad.numpy(), (0, 3, 5)
    np.testing.assert_allclose(np.delete(da.reshape(-1, da.shape[-1]), 3 * shape[2] + 5, 0),
                               np.delete(np.asarray(ga).reshape(-1, da.shape[-1]),
                                         3 * shape[2] + 5, 0), atol=1e-5)
    np.testing.assert_allclose(da[zero], np.asarray(ga)[zero],
                               atol=1e-5 * np.abs(np.asarray(ga)[zero]).max())
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=1e-5)


def test_k4f_detached_teacher_and_dtype():
    rng = np.random.default_rng(3)
    offsets = multi_offset([1, 3, 5, 9, 11], 4)
    a = T(rng.normal(size=(2, 20, 24, 16)).astype(np.float32)).requires_grad_()
    b = _teacher_view(rng.normal(size=(2, 20, 24, 16)).astype(np.float32))
    out = fused_cross_affinity_2d(a, b, offsets)
    out.sum().backward()
    assert a.grad is not None and not b.requires_grad
    bf = fused_cross_affinity_2d(a.detach().bfloat16(), b.bfloat16(), offsets)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), out.detach().numpy(), atol=8e-3)
    torch.testing.assert_close(cross_affinity_2d_plain(a.detach(), b, offsets), out.detach())
    with pytest.raises(ValueError):
        fused_cross_affinity_2d(a, b[:, :-1], offsets)


@pytest.mark.parametrize("name", ["WeightedBCELoss", "BCELoss"])
def test_bce_criteria_match_jax(name):
    rng = np.random.default_rng(5)
    # some clipped at eps; none above 1 - eps, which rounds to 1 in float32
    # and makes both packages' log(1 - p) -inf
    p = rng.uniform(-0.2, 0.99, (2, 9, 13)).astype(np.float32)
    t = (rng.random((2, 9, 13)) > 0.5).astype(np.float32)
    w = (rng.random((2, 9, 13)) * 2 + 0.05).astype(np.float32)
    jfn, fn = JL.CRITERIA[name], L.CRITERIA[name]
    val, grad = jax.value_and_grad(lambda x: jfn(x, t, w))(jnp.asarray(p))
    tp = T(p).requires_grad_()
    got = fn(tp, T(t), T(w))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(grad), atol=1e-5)


def _maps(rng, b, k, h, w):
    t = (rng.random((b, k, h, w)) > 0.5).astype(np.float32)
    wm = (rng.random((b, k, h, w)) * 2.0 + 0.05).astype(np.float32)
    m = (rng.random((b, k, h, w)) > 0.2).astype(np.float32)
    return t, wm, m


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_unfused_bce_losses_match_jax(kind):
    """The kernel path with WeightedBCELoss, which never fuses."""
    rng = np.random.default_rng(11)
    offsets = multi_offset([1, 3, 5, 9, 11], 4)
    b, h, w, c = 2, 33, 28, 16
    e = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ema = rng.normal(size=(b, h, w, c)).astype(np.float32)
    t, wm, m = _maps(rng, b, len(offsets), h, w)
    if kind == "self":
        def fn(x):
            return JL.embedding_loss_2d(x, t, wm, m, offsets, criterion=JL.weighted_bce,
                                        use_pallas=False)[0]
    else:
        def fn(x):
            return JL.ema_embedding_loss_2d(x, ema, t, wm, m, offsets,
                                            criterion=JL.weighted_bce, affs0_weight=2.5,
                                            use_pallas=False)[0]
    val, grad = jax.value_and_grad(fn)(jnp.asarray(e))
    te = T(e).requires_grad_()
    maps = [T(x) for x in (t, wm, m)]
    kw = dict(criterion=L.weighted_bce, use_pallas=True, fuse_loss=True)
    if kind == "self":
        loss, _ = L.embedding_loss_2d(te, *maps, offsets, **kw)
    else:
        loss, _ = L.ema_embedding_loss_2d(te, _teacher_view(ema), *maps, offsets,
                                          affs0_weight=2.5, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-5)
    # BCE's gradient -t/p + (1 - t)/(1 - p) multiplies the float32 rounding
    # of an affinity p near 0 or 1 (~1e-7, dots summed in another order) by
    # up to 1/p: measured up to 2.8e-4 relative at a few dozen pixels
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(grad), atol=1e-5, rtol=1e-3)


FILTERS = (4, 6, 8, 12, 16)


def _batch(seed, side=64):
    rng = np.random.default_rng(seed)
    seg = np.stack([blob_labels(side, side, grid=3, radius=8, seed=seed + i)
                    for i in range(2)]).astype(np.int32)
    return {"image": T(rng.random((2, side, side, 3)).astype(np.float32)),
            "ema_image": T(rng.random((2, side, side, 3)).astype(np.float32)),
            "rules": T(np.array([[1, 0, 1], [0, 1, 1]], np.float32)), "seg": T(seg)}


def test_unfused_step_matches_fused_step_and_routes_through_k1_k4(monkeypatch):
    torch.manual_seed(0)
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    batch = _batch(7)
    offsets = multi_offset([1, 3, 5, 9, 11], 4)
    calls = {"K1": 0, "K4": 0}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "fused_affinity_2d", spy("K1", L.fused_affinity_2d))
    monkeypatch.setattr(L, "fused_cross_affinity_2d", spy("K4", L.fused_cross_affinity_2d))
    runs = {}
    for fused in (True, False):
        step = TrainStep2D(offsets, mask_weight=1000.0, fuse_loss=fused, device_ema=False,
                           imagenet_norm=False)
        _, metrics = step.grads(model, batch)
        runs[fused] = (metrics, {n: p.grad.clone() for n, p in model.named_parameters()})
        assert calls == ({"K1": 0, "K4": 0} if fused else {"K1": 5, "K4": 1})
    for k, v in runs[True][0].items():
        np.testing.assert_allclose(float(runs[False][0][k]), float(v), rtol=1e-6, err_msg=k)
    # gradients relative to each tensor's largest: float32 rounding of the
    # same sums taken in another order
    for n, g in runs[True][1].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(runs[False][1][n].numpy(), g.numpy(), atol=1e-5 * scale,
                                   err_msg=n)
