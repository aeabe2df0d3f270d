"""Port's loss-path ops vs the JAX package's, on the CPU.

* The plain K2/K3 functions (the CPU side of ``fused_affinity_wmse_2d`` /
  ``fused_cross_affinity_wmse_2d``) against the Pallas kernels run in
  interpret mode: affinities and gradients at atol 1e-5, the kernels'
  own bound in ``tests/test_emb2aff_pallas.py`` (gS = 1 / (B * W), the
  train step's scale); the sums S at rtol 1e-5, since S adds ~B*H*W f32
  terms and its rounding is relative.
* Losses (values rtol 1e-5, gradients atol 1e-5), cross affinities
  (1e-6, same f32 math in another order), targets (atol 1e-6) and the
  flips (exact) against the JAX functions.
* The EMA view's random draws cannot match JAX's bits: intensity and
  mask are tested by behaviour and distribution, as
  ``tests/test_aug_distributions.py`` tests the JAX package's.
* AMSGrad against optax over 3 steps at atol 1e-7 (parameters kept in
  (-1, 1), where one float32 ulp is at most 6e-8).
* On a CUDA card only (skipped here): K3b without db against its db form,
  and db through autograd for a teacher that requires grad.
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

from pixel_embedded_affinity_tpu.data.consistency import convert_consistency_flip_jax
from pixel_embedded_affinity_tpu.data.device_aug import flip_2d as jax_flip_2d
from pixel_embedded_affinity_tpu.ops import losses as JL
from pixel_embedded_affinity_tpu.ops.affinity_jax import build_targets_2d_jax, gen_affs_jax
from pixel_embedded_affinity_tpu.ops.emb2aff import cross_affinity_2d as jax_cross_affinity_2d
from pixel_embedded_affinity_tpu.ops.emb2aff_pallas import (
    fused_affinity_wmse_2d as jax_wmse, fused_cross_affinity_wmse_2d as jax_cross_wmse)
from pixel_embedded_affinity_tpu.train.optim import make_optimizer

from pixel_embedded_affinity_torch.data.consistency import convert_consistency_flip
from pixel_embedded_affinity_torch.data.device_aug import (
    add_intensity_2d, add_mask_2d, ema_generator, ema_view_2d, flip_2d)
from pixel_embedded_affinity_torch.ops import (
    cross_affinity_2d, fused_affinity_wmse_2d, fused_cross_affinity_wmse_2d, multi_offset)
from pixel_embedded_affinity_torch.ops import losses as L
from pixel_embedded_affinity_torch.ops.emb2aff_wmse_cuda import (
    cross_affinity_wmse_2d_plain, cross_wmse2d_bwd, wmse2d_fwd)
from pixel_embedded_affinity_torch.ops.targets import build_targets_2d, gen_affs
from pixel_embedded_affinity_torch.train.optim import AMSGrad

from synth import blob_labels

T = torch.from_numpy


def _maps(rng, b, k, h, w):
    t = (rng.random((b, k, h, w)) > 0.5).astype(np.float32)
    wm = (rng.random((b, k, h, w)) * 2.0 + 0.05).astype(np.float32)
    m = (rng.random((b, k, h, w)) > 0.2).astype(np.float32)
    return t, wm, m


# (kind, embedding shape, shifts, neighbor): the main-path offsets, and the
# neighbor-8 set whose offsets also look right (ox > 0)
WMSE_CASES = [("self", (2, 37, 29, 16), [1, 3, 5, 9, 27], 4),
              ("self", (1, 40, 36, 8), [1, 3], 8),
              ("cross", (2, 37, 29, 16), [1, 3, 5, 9, 27], 4),
              ("cross", (1, 40, 36, 8), [1, 3], 8)]


@pytest.fixture(scope="module")
def wmse_jax():
    """Inputs and the interpret-mode Pallas results of every WMSE_CASES entry."""
    out = []
    for i, (kind, shape, shifts, neighbor) in enumerate(WMSE_CASES):
        rng = np.random.default_rng(100 + i)
        offsets = multi_offset(shifts, neighbor)
        b, h, w, _ = shape
        a = rng.normal(size=shape).astype(np.float32)
        bb = rng.normal(size=shape).astype(np.float32)
        t, wm, m = _maps(rng, b, len(offsets), h, w)
        gs = (rng.random(len(offsets)).astype(np.float32) + 0.5) / (b * w)
        offs = tuple(map(tuple, offsets))
        if kind == "self":
            def f(x, _):
                return jax_wmse(x, t, wm, m, offs, 32, True)
        else:
            def f(x, y):
                return jax_cross_wmse(x, y, t, wm, m, offs, 32, True)
        (s, affs), vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(bb))
        ga, gb = vjp((jnp.asarray(gs), jnp.zeros_like(affs)))
        res = [np.asarray(v) for v in (s, affs, ga, gb)]
        out.append(dict(offsets=offsets, a=a, b=bb, t=t, w=wm, m=m, gs=gs, res=res))
    return out


@pytest.mark.parametrize("idx", range(len(WMSE_CASES)))
def test_wmse_plain_matches_pallas_interpret(wmse_jax, idx):
    case = wmse_jax[idx]
    kind = WMSE_CASES[idx][0]
    s_j, affs_j, ga_j, gb_j = case["res"]
    a = T(case["a"]).requires_grad_()
    b = T(case["b"]).requires_grad_()
    maps = [T(case[k]) for k in "twm"]
    before = wmse2d_fwd.launches
    if kind == "self":
        s, affs = fused_affinity_wmse_2d(a, *maps, case["offsets"])
    else:
        s, affs = fused_cross_affinity_wmse_2d(a, b, *maps, case["offsets"])
    assert wmse2d_fwd.launches == before  # the CPU runs the plain version
    assert not affs.requires_grad  # monitoring output, as in the JAX contract
    np.testing.assert_allclose(s.detach().numpy(), s_j, rtol=1e-5)
    np.testing.assert_allclose(affs.numpy(), affs_j, atol=1e-5)
    torch.sum(s * T(case["gs"])).backward()
    np.testing.assert_allclose(a.grad.numpy(), ga_j, atol=1e-5)
    if kind == "cross":
        np.testing.assert_allclose(b.grad.numpy(), gb_j, atol=1e-5)
    else:
        assert b.grad is None


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.skipif(not torch.cuda.is_available(), reason="K3b runs only on a CUDA card")
def test_cross_wmse_bwd_kernel_computes_db_only_when_asked():
    """K3b without db gives the db form's da and no db; through autograd a
    teacher that requires grad gets the plain version's db (1e-5 of the
    largest gradient, chip_smoke's GRAD_RTOL; the two kernel forms are
    compiled apart, so their da agree to rounding)."""
    rng = np.random.default_rng(11)
    b, h, w = 2, 37, 29
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    k = len(offsets)
    # the model's NCHW output permuted to (B, H, W, C), as the step hands it
    a, bb = (T(rng.normal(size=(b, 16, h, w)).astype(np.float32)).cuda().permute(0, 2, 3, 1)
             for _ in range(2))
    maps = [T(x).cuda() for x in _maps(rng, b, k, h, w)]
    gs = T(((rng.random(k) + 0.5) / (b * w)).astype(np.float32)).cuda()
    da, no_db = cross_wmse2d_bwd(a, bb, *maps, gs, offsets, need_db=False)
    da_with, db = cross_wmse2d_bwd(a, bb, *maps, gs, offsets)
    assert no_db is None and db is not None
    assert _rel_err(da, da_with) <= 1e-6

    got = [x.detach().clone().requires_grad_() for x in (a, bb)]
    ref = [x.detach().clone().requires_grad_() for x in (a, bb)]
    s, _ = fused_cross_affinity_wmse_2d(*got, *maps, offsets)
    torch.sum(s * gs).backward()
    s_ref, _ = cross_affinity_wmse_2d_plain(*ref, *maps, offsets)
    torch.sum(s_ref * gs).backward()
    for g, r in zip(got, ref):
        assert _rel_err(g.grad, r.grad) <= 1e-5


@pytest.mark.parametrize("neighbor", [4, 8])
def test_cross_affinity_2d_matches_jax_with_grads(neighbor):
    rng = np.random.default_rng(neighbor)
    a = rng.normal(size=(2, 23, 31, 8)).astype(np.float32)
    b = rng.normal(size=(2, 23, 31, 8)).astype(np.float32)
    a[0, 3, 5] = 0.0
    offsets = multi_offset([1, 3, 9], neighbor)
    g = rng.normal(size=(2, len(offsets), 23, 31)).astype(np.float32)
    exp, vjp = jax.vjp(lambda x, y: jax_cross_affinity_2d(x, y, offsets),
                       jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(g))
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    got = cross_affinity_2d(ta, tb, offsets)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), atol=1e-6)
    (got * T(g)).sum().backward()
    # The zero vector's gradient is the cotangent of its normalised vector
    # times 1 / eps = 1e12 (both packages clamp the norm at eps = 1e-12,
    # the same formula): about 1e10-1e12, where one float32 ulp is
    # 4096-131072. That cotangent sums a term an offset, which the two
    # libraries add in another order, so the two gradients part there by
    # 1 ulp of the vector's largest gradient (measured, both neighbours),
    # the port's within 0.5 ulp of its float64 gradient. The zero
    # vector's gradient is held at 2 ulps of its own largest value, against
    # JAX's and against float64; every other element at atol 1e-5.
    zero = np.zeros(a.shape[:3], bool)
    zero[0, 3, 5] = True
    ga = np.asarray(ga)
    np.testing.assert_allclose(ta.grad.numpy()[~zero], ga[~zero], atol=1e-5)
    ta64 = T(a.astype(np.float64)).requires_grad_()
    (cross_affinity_2d(ta64, T(b.astype(np.float64)), offsets)
     * T(g.astype(np.float64))).sum().backward()
    ulp = np.spacing(np.abs(ga[zero]).max())
    for ref in (ga[zero], ta64.grad.numpy()[zero]):
        assert np.abs(ta.grad.numpy()[zero] - ref).max() <= 2 * ulp
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=1e-5)


def test_weighted_mse_keeps_the_bw_normaliser():
    rng = np.random.default_rng(0)
    p, t, w = (rng.random((2, 9, 13)).astype(np.float32) for _ in range(3))
    got = float(L.weighted_mse(T(p), T(t), T(w)))
    np.testing.assert_allclose(got, float(JL.weighted_mse(p, t, w)), rtol=1e-6)
    np.testing.assert_allclose(got, float(np.sum(w * (p - t) ** 2) / (2 * 13)), rtol=1e-6)
    assert set(L.CRITERIA) == {"WeightedMSELoss", "WeightedBCELoss", "MSELoss", "BCELoss"}


@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(7)
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    b, h, w, c = 2, 35, 30, 16
    e = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ema = rng.normal(size=(b, h, w, c)).astype(np.float32)
    t, wm, m = _maps(rng, b, len(offsets), h, w)

    def self_loss(x):
        return JL.embedding_loss_2d(x, t, wm, m, offsets, use_pallas=False)[0]

    def cross_loss(x):
        return JL.ema_embedding_loss_2d(x, ema, t, wm, m, offsets, affs0_weight=2.5,
                                        use_pallas=False)[0]

    res = {}
    for name, fn in [("self", self_loss), ("cross", cross_loss)]:
        val, grad = jax.value_and_grad(fn)(jnp.asarray(e))
        res[name] = (float(val), np.asarray(grad))
    return dict(offsets=offsets, e=e, ema=ema, t=t, w=wm, m=m, res=res)


@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("fused", [True, False])
def test_embedding_losses_match_jax(loss_case, kind, fused):
    c = loss_case
    e = T(c["e"]).requires_grad_()
    maps = [T(c[k]) for k in "twm"]
    kw = dict(use_pallas=fused, fuse_loss=fused)
    if kind == "self":
        loss, affs = L.embedding_loss_2d(e, *maps, c["offsets"], **kw)
    else:
        loss, affs = L.ema_embedding_loss_2d(e, T(c["ema"]), *maps, c["offsets"],
                                             affs0_weight=2.5, **kw)
    assert affs.shape == (2, 10, 35, 30)
    loss.backward()
    val, grad = c["res"][kind]
    np.testing.assert_allclose(float(loss.detach()), val, rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), grad, atol=1e-5)


def _labels(shape, seed):
    b, h, w = shape
    lab = np.stack([blob_labels(h, w, grid=3, radius=min(h, w) // 9, seed=seed + i)
                    for i in range(b)]).astype(np.int32)
    lab[-1] = 0  # a uniform plane: weights all ones
    return lab


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 66, 50)])
def test_build_targets_2d_matches_jax(shape):
    lab = _labels(shape, 3)
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    exp = build_targets_2d_jax(jnp.asarray(lab), offsets)
    got = build_targets_2d(T(lab), offsets)
    for g, x in zip(got[:3], exp[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)
    assert len(got[3]) == len(exp[3]) == 4
    for g, x in zip(got[3], exp[3]):
        g = torch.cat(g, dim=1)  # the JAX package stacks (affs | weights | masks)
        assert g.shape == x.shape  # banker's-rounded pyramid sizes (66 -> 33 -> 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)


def test_gen_affs_without_padding_matches_jax():
    lab = _labels((2, 30, 40), 5)
    offsets = multi_offset([1, 3, 9], 8)
    for pad in (True, False):
        ga, gm = gen_affs(T(lab), offsets, padding=pad)
        ja, jm = gen_affs_jax(jnp.asarray(lab), offsets, padding=pad)
        np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))


RULES = np.array([[x, y, t] for x in (0, 1) for y in (0, 1) for t in (0, 1)], np.float32)


def test_unflip_matches_jax_exactly():
    e = np.random.default_rng(1).normal(size=(8, 12, 12, 5)).astype(np.float32)
    got = convert_consistency_flip(T(e), T(RULES)).numpy()
    exp = np.asarray(convert_consistency_flip_jax(jnp.asarray(e), jnp.asarray(RULES)))
    np.testing.assert_array_equal(got, exp)
    # on the model's NCHW output passed as its (B, H, W, C) view
    nchw = T(np.ascontiguousarray(e.transpose(0, 3, 1, 2)))
    view = convert_consistency_flip(nchw.permute(0, 2, 3, 1), T(RULES)).numpy()
    np.testing.assert_array_equal(view, exp)


@pytest.mark.parametrize("rule", [None] + [tuple(int(v) for v in r) for r in RULES],
                         ids=lambda r: "mixed" if r is None else "rule-%d%d%d" % r)
def test_unflip_keeps_the_students_layout(rule):
    """On the model's NCHW output seen as (B, H, W, C), the un-flipped
    teacher has the student's strides (the affinity kernels then read both
    alike) for every rule, one for the batch or each sample its own, and
    still equals JAX's bit for bit."""
    rules = RULES if rule is None else np.asarray([rule, rule], np.float32)
    nchw = np.random.default_rng(3).normal(size=(len(rules), 5, 12, 12)).astype(np.float32)
    student = T(nchw).permute(0, 2, 3, 1)
    got = convert_consistency_flip(student, T(rules))
    assert got.stride() == student.stride()
    exp = convert_consistency_flip_jax(jnp.asarray(nchw.transpose(0, 2, 3, 1)),
                                       jnp.asarray(rules))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_flip_2d_matches_jax_and_is_undone():
    img = np.random.default_rng(2).random((8, 10, 10, 3)).astype(np.float32)
    got = flip_2d(T(img), T(RULES))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_flip_2d(jnp.asarray(img),
                                                                      jnp.asarray(RULES))))
    np.testing.assert_array_equal(convert_consistency_flip(got, T(RULES)).numpy(), img)


def _ks_uniform(x, lo, hi):
    x = np.sort((np.asarray(x, np.float64) - lo) / (hi - lo))
    return float(np.max(np.abs(np.arange(1, len(x) + 1) / len(x) - x)))


def test_intensity_draws_contrast_and_brightness_per_sample():
    """out = x * (1 + (u - 0.5) 0.1) + (v - 0.5) 0.1: contrast in [0.95,
    1.05], brightness in [-0.05, 0.05], both uniform, one pair per sample."""
    n = 4000
    img = torch.tensor([0.25, 0.75]).reshape(1, 1, 2, 1).expand(n, 1, 2, 1)
    out = add_intensity_2d(img, ema_generator(0, 0, "cpu")).numpy()[:, 0, :, 0]
    c = (out[:, 1] - out[:, 0]) / 0.5
    br = out[:, 0] - 0.25 * c
    assert 0.95 - 1e-6 <= c.min() < 0.951 and 1.049 < c.max() <= 1.05 + 1e-6
    assert -0.05 - 1e-6 <= br.min() < -0.049 and 0.049 < br.max() <= 0.05 + 1e-6
    assert _ks_uniform(c, 0.95, 1.05) < 0.03 and _ks_uniform(br, -0.05, 0.05) < 0.03
    assert np.all(add_intensity_2d(img * 20, ema_generator(0, 1, "cpu")).numpy() <= 1.0)


def test_mask_fills_squares_inside_the_fg_box_with_the_fg_mean():
    rng = np.random.default_rng(4)
    b, h, w = 64, 48, 40
    img = T(rng.random((b, h, w, 3)).astype(np.float32))
    fg = np.zeros((b, h, w), np.int32)
    fg[:, 6:40, 5:36] = 1
    fg[:, 20:24, 10:30] = 0  # a hole: the box is what bounds the squares
    fg[-1] = 0  # no foreground: the image passes unchanged
    out = add_mask_2d(img, T(fg), ema_generator(3, 0, "cpu"))
    changed = (out != img).any(dim=-1).numpy()
    fgt = T(fg).float()[..., None]
    means = ((img * fgt).sum((1, 2)) / fgt.sum((1, 2)).clamp(min=1)).numpy()
    assert not changed[:, :6].any() and not changed[:, 40:].any()
    assert not changed[:, :, :5].any() and not changed[:, :, 36:].any()
    assert not changed[-1].any()
    for i in range(b):
        np.testing.assert_allclose(out[i].numpy()[changed[i]],
                                   np.broadcast_to(means[i], (changed[i].sum(), 3)),
                                   atol=1e-6)
    # squares of up to 20 px, up to 20 of them: some samples get none
    n_changed = changed.reshape(b, -1).sum(1)
    assert (n_changed == 0).sum() >= 1 and (n_changed > 0).sum() > b // 2
    assert n_changed.max() <= 20 * 20 * 20


def test_ema_view_is_seeded_by_seed_and_step():
    img = T(np.random.default_rng(5).random((4, 16, 16, 3)).astype(np.float32))
    fg = T((np.random.default_rng(6).random((4, 16, 16)) > 0.3).astype(np.int32))
    a = ema_view_2d(img, fg, ema_generator(7, 3, "cpu"))
    b = ema_view_2d(img, fg, ema_generator(7, 3, "cpu"))
    c = ema_view_2d(img, fg, ema_generator(7, 4, "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    rules = ema_view_2d(img[:1].expand(512, 16, 16, 3), fg[:1].expand(512, 16, 16),
                        ema_generator(0, 0, "cpu"))[1].numpy()
    assert set(np.unique(rules)) == {0.0, 1.0} and abs(rules.mean() - 0.5) < 0.05
    # the noise and blur links are ported: seeded the same way, drawn in
    # front of the others, and the view stays in [0, 1]
    for flag in ("noise", "blur"):
        d = ema_view_2d(img, fg, ema_generator(7, 3, "cpu"), **{flag: True})
        e = ema_view_2d(img, fg, ema_generator(7, 3, "cpu"), **{flag: True})
        assert torch.equal(d[0], e[0]) and not torch.equal(d[0], a[0])
        assert float(d[0].min()) >= 0 and float(d[0].max()) <= 1


def test_amsgrad_matches_optax_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = [(4, 3, 3, 3), (4,), (7, 5)]
    params = [rng.uniform(-0.9, 0.9, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = make_optimizer(1e-4)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(T(p.copy())) for p in params]
    opt = AMSGrad(tp, lr=1e-4, eps=0.01, weight_decay=1e-6)
    adam = [torch.nn.Parameter(T(p.copy())) for p in params]
    torch_adam = torch.optim.Adam(adam, lr=1e-4, eps=0.01, weight_decay=1e-6, amsgrad=True)
    for step, gs in enumerate(grads):
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, q, g in zip(tp, adam, gs):
            p.grad, q.grad = T(g), T(g.copy())
        opt.step()
        torch_adam.step()
        for p, j in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-7, rtol=0)
    # torch's amsgrad (max of the raw moment) is a different update from step 2
    assert max(float((p - q).abs().max()) for p, q in zip(tp, adam)) > 1e-6
