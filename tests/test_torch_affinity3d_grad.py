"""The port's 3D training ops vs the JAX package's, on the CPU.

* The plain versions of the self-affinity backward, the cross forward and
  the cross backward (the CPU side of ``fused_affinity_3d`` and
  ``fused_cross_affinity_3d`` with autograd, and ``affinity_bwd_plain`` /
  ``cross_affinity_bwd_plain``) against ``jax.vjp`` of the Pallas kernels
  run in interpret mode, with the full 12-shift table, a zero vector and a
  random cotangent over the whole output (its values where the neighbour
  lies outside must count for nothing). Forward at atol 1e-5; gradients
  within 1e-5 of the largest, the zero vector's voxel held apart: the
  normalisation's VJP scales its gradient by 1e12, so it is held relative
  to its own largest. The raw (normalized=True) forms against the TPU's 2D
  backward kernels over B*D slices, K1's 2D backward against ``jax.vjp`` of
  ``fused_affinity_2d``, neighbor 8 included.
* Targets (bit for bit), the norm1/norm5 losses (values at rtol 2e-6,
  sums of ~1e4 float32 terms in another order; gradients within 1e-5 of
  the largest), the rule-4 flips (exact) against the JAX functions.
* The 3D EMA view's draws cannot match JAX's bits: the intensity jitter
  and the cutout are tested by formula and distribution.
* The PNI model's BatchNorm running statistics against Flax's.
"""

import os
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.data.ac3ac4 import convert_consistency_flip_jax_3d_rule4
from pixel_embedded_affinity_tpu.data.device_aug import (
    cutout_3d as jax_cutout_3d, flip_3d_rule4 as jax_flip_3d_rule4)
from pixel_embedded_affinity_tpu.models.unet3d_pni import UNetPNIEmbeddingDeep as FlaxPNI
from pixel_embedded_affinity_tpu.ops import losses as JL
from pixel_embedded_affinity_tpu.ops.affinity_jax import build_targets_3d_jax
from pixel_embedded_affinity_tpu.ops.emb2aff_pallas import (
    _fused_affinity_2d_bwd_impl, _fused_cross_bwd_impl, fused_affinity_2d as jax_fused_2d,
    fused_affinity_3d as jax_fused_3d, fused_cross_affinity_3d as jax_fused_cross_3d)

from pixel_embedded_affinity_torch.convert import unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.data.ac3ac4 import convert_consistency_flip_3d_rule4
from pixel_embedded_affinity_torch.data.device_aug import (
    cutout_3d, ema_generator, ema_intensity_params_3d, ema_view_3d, flip_3d_rule4, intensity_3d)
from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.ops import (
    SHIFTS_3D, affinity_bwd, affinity_bwd_plain, cross_affinity_bwd, cross_affinity_bwd_plain,
    cross_affinity_fwd, fused_affinity_2d, fused_affinity_3d, fused_cross_affinity_3d,
    multi_offset, offsets_3d)
from pixel_embedded_affinity_torch.ops import losses as L
from pixel_embedded_affinity_torch.ops.targets import build_targets_3d

from synth import tile_labels_3d

T = torch.from_numpy
ZERO = (0, 1, 3, 5)  # the zero vector's voxel (b, z, y, x)
GRAD_RTOL = 1e-5


def _launches():
    return (fused_affinity_3d.launches, affinity_bwd.launches, cross_affinity_fwd.launches,
            cross_affinity_bwd.launches, fused_affinity_2d.launches)


def _emb(shape, seed):
    e = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    e[ZERO] = 0.0
    return e


def _check_grad(got, exp, zero=ZERO):
    """Within GRAD_RTOL of the largest gradient, the zero vector's voxel
    apart and held relative to its own largest."""
    got, exp = np.asarray(got), np.asarray(exp)
    keep = np.ones(exp.shape[:-1], bool)
    keep[zero] = False
    np.testing.assert_allclose(got[keep], exp[keep], rtol=0,
                               atol=GRAD_RTOL * np.abs(exp[keep]).max())
    np.testing.assert_allclose(got[zero], exp[zero], rtol=0,
                               atol=GRAD_RTOL * np.abs(exp[zero]).max())


# the full shift table at a volume that holds every shift, and one where
# H, W < 27 put the two 27-channels wholly outside
@pytest.mark.parametrize("shape", [(1, 6, 40, 36, 8), (1, 5, 20, 25, 16)])
def test_self_affinity_3d_and_backward_match_jax(shape):
    e = _emb(shape, 1)
    g = np.random.default_rng(2).normal(size=(shape[0], 12) + shape[1:4]).astype(np.float32)
    exp, vjp = jax.vjp(lambda x: jax_fused_3d(x, SHIFTS_3D, 32, True), jnp.asarray(e))
    (ge,) = vjp(jnp.asarray(g))
    before = _launches()
    x = T(e).requires_grad_()
    got = fused_affinity_3d(x)
    got.backward(T(g))
    assert _launches() == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), atol=1e-5)
    _check_grad(x.grad.numpy(), ge)
    _check_grad(affinity_bwd_plain(T(e), T(g), offsets_3d()).numpy(), ge)


@pytest.mark.parametrize("shape", [(1, 6, 40, 36, 8), (1, 5, 20, 25, 16)])
def test_cross_affinity_3d_and_backward_match_jax(shape):
    a, b = _emb(shape, 3), _emb(shape, 4)
    g = np.random.default_rng(5).normal(size=(shape[0], 12) + shape[1:4]).astype(np.float32)
    exp, vjp = jax.vjp(lambda x, y: jax_fused_cross_3d(x, y, SHIFTS_3D, 32, True),
                       jnp.asarray(a), jnp.asarray(b))
    ga, gb = vjp(jnp.asarray(g))
    before = _launches()
    xa, xb = T(a).requires_grad_(), T(b).requires_grad_()
    got = fused_cross_affinity_3d(xa, xb)
    got.backward(T(g))
    assert _launches() == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), atol=1e-5)
    _check_grad(xa.grad.numpy(), ga)
    _check_grad(xb.grad.numpy(), gb)
    da, db = cross_affinity_bwd_plain(T(a), T(b), T(g), offsets_3d())
    _check_grad(da.numpy(), ga)
    _check_grad(db.numpy(), gb)
    # a detached teacher gets no gradient
    xa = T(a).requires_grad_()
    fused_cross_affinity_3d(xa, T(b)).backward(T(g))
    _check_grad(xa.grad.numpy(), ga)


def _xy_part(shape, seed):
    """Unit vectors, the xy channels' 2D offsets as (dy, dx) and as
    (0, dy, dx), and a cotangent for them in both layouts."""
    b, d, h, w, c = shape
    rng = np.random.default_rng(seed)
    n = rng.normal(size=shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    xy = [(-s, 0) if i % 3 == 1 else (0, -s) for i, s in enumerate(SHIFTS_3D) if i % 3]
    g = rng.normal(size=(b, len(xy), d, h, w)).astype(np.float32)
    g2d = np.moveaxis(g, 1, 2).reshape(b * d, len(xy), h, w)
    return n, xy, [(0,) + o for o in xy], g, g2d


def test_raw_self_backward_matches_the_tpu_2d_pass():
    """normalized=True: dn of the xy channels against the TPU's 2D backward
    kernel over the B*D slices, as the TPU's 3D backward calls it."""
    shape = (2, 4, 40, 36, 8)
    n, xy, xyz, g, g2d = _xy_part(shape, 6)
    exp = _fused_affinity_2d_bwd_impl(jnp.asarray(n.reshape(-1, *shape[2:])), jnp.asarray(g2d),
                                      tuple(xy), True, 32, True)
    got = affinity_bwd_plain(T(n), T(g), xyz, normalized=True).numpy()
    np.testing.assert_allclose(got.reshape(-1, *shape[2:]), np.asarray(exp), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(exp)).max())


def test_raw_cross_backward_matches_the_tpu_2d_pass():
    shape = (2, 4, 40, 36, 8)
    na, xy, xyz, g, g2d = _xy_part(shape, 7)
    nb = _xy_part(shape, 8)[0]
    flat = [jnp.asarray(v.reshape(-1, *shape[2:])) for v in (na, nb)]
    exp = _fused_cross_bwd_impl(*flat, jnp.asarray(g2d), tuple(xy), 32, True, normalized=True)
    got = cross_affinity_bwd_plain(T(na), T(nb), T(g), xyz, normalized=True)
    for x, e in zip(got, exp):
        e = np.asarray(e)
        np.testing.assert_allclose(x.numpy().reshape(e.shape), e, rtol=0,
                                   atol=GRAD_RTOL * np.abs(e).max())


@pytest.mark.parametrize("neighbor", [4, 8])
def test_k1_backward_matches_jax_and_is_the_3d_backward_at_depth_one(neighbor):
    """K1's 2D backward runs on the card as the self-affinity backward
    kernel at D = 1 with offsets (0, dy, dx): its plain version in that form
    equals jax.vjp of the Pallas fused_affinity_2d, as the port's 2D
    wrapper's gradient on the CPU does."""
    offsets = multi_offset([1, 3, 5, 9, 27], neighbor)
    e = np.random.default_rng(9).normal(size=(2, 40, 36, 16)).astype(np.float32)
    e[0, 3, 5] = 0.0
    g = np.random.default_rng(10).normal(size=(2, len(offsets), 40, 36)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_fused_2d(x, offsets, 32, True), jnp.asarray(e))
    (ge,) = vjp(jnp.asarray(g))
    x = T(e).requires_grad_()
    fused_affinity_2d(x, offsets).backward(T(g))
    _check_grad(x.grad.numpy(), ge, zero=(0, 3, 5))
    d1 = affinity_bwd_plain(T(e)[:, None], T(g)[:, :, None], [(0, dy, dx) for dy, dx in offsets])
    _check_grad(d1[:, 0].numpy(), ge, zero=(0, 3, 5))


def _labels(shape, seed, background=True):
    b, d, h, w = shape
    lab = np.stack([tile_labels_3d(d, h, w, 2, 3, 3) + 10 * i for i in range(b)])
    if background:
        rng = np.random.default_rng(seed)
        lab[rng.random(lab.shape) < 0.15] = 0  # scattered background
        lab[:, :, 5:15, 20:33] = 0              # and a block of it
    return lab.astype(np.int32)


# labels with background; one label everywhere; background everywhere
@pytest.mark.parametrize("kind", ["background", "one label", "all background"])
def test_build_targets_3d_matches_jax_bit_for_bit(kind):
    lab = _labels((2, 6, 48, 40), 11, kind == "background")
    if kind != "background":
        lab[:] = 7 if kind == "one label" else 0
    ja, jw, jd = jax.jit(build_targets_3d_jax)(jnp.asarray(lab))
    affs, wmap, downs = build_targets_3d(T(lab))
    np.testing.assert_array_equal(affs.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(wmap.numpy(), np.asarray(jw))
    assert len(downs) == len(jd) == 4
    for (a, w), d in zip(downs, jd):
        np.testing.assert_array_equal(torch.cat([a, w], dim=1).numpy(), np.asarray(d))
    if kind == "all background":  # every channel is uniform: weight 1
        assert bool((wmap == 1).all()) and all(bool((w == 1).all()) for _, w in downs)


@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(12)
    shape = (2, 6, 32, 32, 8)
    lab = _labels(shape[:4], 13)
    affs, wmap, _ = jax.jit(build_targets_3d_jax)(jnp.asarray(lab))
    return {"e": rng.normal(size=shape).astype(np.float32),
            "ema": rng.normal(size=shape).astype(np.float32),
            "t": np.asarray(affs), "w": np.asarray(wmap), "jax": {}}


def _jax_loss(c, mode, kind):
    """(loss, affs, d loss / d e) of the JAX loss, jitted, once per case."""
    if (mode, kind) not in c["jax"]:
        t, w = (c["t"][:, :3], c["w"][:, :3]) if mode == 1 else (c["t"], c["w"])
        ema = jnp.asarray(c["ema"]) if kind == "cross" else None
        if mode == 5:
            def fn(x):
                return JL.embedding_loss_norm5(x, t, w, affs0_weight=2.5,
                                               ema_embedding_bdhwc=ema, use_pallas=False)
        else:
            def fn(x):
                return JL.embedding_loss_norm1(x, t, w, affs0_weight=2.5,
                                               ema_embedding_bdhwc=ema)
        (loss, affs), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(jnp.asarray(c["e"]))
        c["jax"][(mode, kind)] = (float(loss), np.asarray(affs), np.asarray(g))
    return c["jax"][(mode, kind)]


# the loss at rtol 2e-6: each channel's criterion sums ~1.2e4 float32
# terms, in another order than XLA's (measured 1.0e-6 apart at most)
@pytest.mark.parametrize("mode", [1, 5])
@pytest.mark.parametrize("kind", ["self", "cross"])
@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_3d_losses_match_jax(loss_case, mode, kind, kernels):
    c = loss_case
    exp, exp_affs, ge = _jax_loss(c, mode, kind)
    t, w = (c["t"][:, :3], c["w"][:, :3]) if mode == 1 else (c["t"], c["w"])
    kw = dict(affs0_weight=2.5, ema_embedding_bdhwc=T(c["ema"]) if kind == "cross" else None)
    e = T(c["e"]).requires_grad_()
    if mode == 5:
        loss, affs = L.embedding_loss_norm5(e, T(t.copy()), T(w.copy()), use_pallas=kernels, **kw)
    else:
        loss, affs = L.embedding_loss_norm1(e, T(t.copy()), T(w.copy()), **kw)
    np.testing.assert_allclose(loss.item(), exp, rtol=2e-6)
    np.testing.assert_allclose(affs.detach().numpy(), exp_affs, atol=1e-6)
    loss.backward()
    np.testing.assert_allclose(e.grad.numpy(), ge, rtol=0, atol=1e-5 * np.abs(ge).max())


RULES4 = np.array([[int(b) for b in f"{i:04b}"] for i in range(16)], np.float32)


def test_rule4_flips_match_jax_exactly_and_invert_each_other():
    x = np.random.default_rng(14).normal(size=(16, 3, 7, 7, 2)).astype(np.float32)
    got = flip_3d_rule4(T(x), T(RULES4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_flip_3d_rule4(jnp.asarray(x), jnp.asarray(RULES4))))
    back = convert_consistency_flip_3d_rule4(got, T(RULES4))
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        convert_consistency_flip_jax_3d_rule4(jnp.asarray(got.numpy()), jnp.asarray(RULES4))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("rule", [None] + [tuple(int(v) for v in r) for r in RULES4],
                         ids=lambda r: "mixed" if r is None else "rule-%d%d%d%d" % r)
def test_rule4_unflip_keeps_the_students_layout(rule):
    """On the 3D model's channels-last NCDHW output seen as (B, D, H, W, C),
    the un-flipped teacher has the student's strides for every rule, one
    for the batch or each sample its own, and still equals JAX's bit for
    bit."""
    rules = RULES4 if rule is None else np.asarray([rule, rule], np.float32)
    x = np.random.default_rng(15).normal(size=(len(rules), 3, 7, 7, 4)).astype(np.float32)
    ncdhw = T(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))).contiguous(
        memory_format=torch.channels_last_3d)
    student = ncdhw.permute(0, 2, 3, 4, 1)
    got = convert_consistency_flip_3d_rule4(student, T(rules))
    assert got.stride() == student.stride()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        convert_consistency_flip_jax_3d_rule4(jnp.asarray(x), jnp.asarray(rules))))


def _ks_uniform(x, lo, hi):
    x = np.sort((np.asarray(x, np.float64) - lo) / (hi - lo))
    return float(np.max(np.abs(np.arange(1, len(x) + 1) / len(x) - x)))


def test_intensity_3d_is_the_formula_with_per_slice_draws():
    b, d = 2000, 3
    img = T(np.random.default_rng(15).random((b, d, 4, 4, 1)).astype(np.float32))
    do, c, br, g = ema_intensity_params_3d(ema_generator(1, 2, "cpu"), b, d, img)
    out = intensity_3d(img, ema_generator(1, 2, "cpu"))
    exp = np.clip(np.clip(img.numpy() * c.numpy() + br.numpy(), 0, 1) ** g.numpy(), 0, 1)
    exp = np.where(do.numpy(), exp, img.numpy())
    np.testing.assert_allclose(out.numpy(), exp, rtol=1e-6, atol=1e-7)
    assert do.shape == (b, 1, 1, 1, 1) and c.shape == br.shape == g.shape == (b, d, 1, 1, 1)
    assert abs(do.float().mean().item() - 0.5) < 0.04  # the gate, p = 0.5
    c, br, lg = c.numpy().ravel(), br.numpy().ravel(), np.log2(g.numpy().ravel())
    assert 0.95 - 1e-6 <= c.min() and c.max() <= 1.05 + 1e-6
    assert -0.05 - 1e-6 <= br.min() and br.max() <= 0.05 + 1e-6
    assert -1 - 1e-6 <= lg.min() and lg.max() <= 1 + 1e-6
    for v, lo, hi in ((c, 0.95, 1.05), (br, -0.05, 0.05), (lg, -1, 1)):
        assert _ks_uniform(v, lo, hi) < 0.03
    # per slice: two slices of one sample get different parameters
    assert (c.reshape(b, d)[:, 0] != c.reshape(b, d)[:, 1]).mean() > 0.99


def test_cutout_3d_boxes_match_the_jax_distribution():
    """Boxes zero the volume: one (sz, sxy) pair per sample, up to 60 of
    them; the zeroed share per sample spreads as JAX's does."""
    shape = (256, 12, 48, 48, 1)
    ones = np.ones(shape, np.float32)
    got = cutout_3d(T(ones), ema_generator(3, 0, "cpu")).numpy()
    exp = np.asarray(jax.jit(jax_cutout_3d)(jnp.asarray(ones), jax.random.PRNGKey(3)))
    assert set(np.unique(got)) <= {0.0, 1.0}
    share, share_j = 1 - got.mean(axis=(1, 2, 3, 4)), 1 - exp.mean(axis=(1, 2, 3, 4))
    assert (share == 0).mean() > 0 and (share > 0).mean() > 0.9
    # quantiles of the zeroed share agree within what 256 samples resolve
    for q in (0.25, 0.5, 0.75):
        assert abs(np.quantile(share, q) - np.quantile(share_j, q)) < 0.06, q
    # a box spans 5..10 slices and 10..20 rows: a zeroed run along z or y
    # of one sample is at least that long, or reaches the volume's edge
    z_run = (got[..., 0] == 0).any(axis=(2, 3)).sum(axis=1)
    assert np.all((z_run == 0) | (z_run >= 5))


def test_ema_view_3d_is_seeded_by_seed_and_step():
    img = T(np.random.default_rng(16).random((4, 6, 16, 16, 1)).astype(np.float32))
    a = ema_view_3d(img, ema_generator(7, 3, "cpu"))
    b = ema_view_3d(img, ema_generator(7, 3, "cpu"))
    c = ema_view_3d(img, ema_generator(7, 4, "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    rules = ema_view_3d(img[:1].expand(512, 6, 16, 16, 1), ema_generator(0, 0, "cpu"))[1]
    assert set(np.unique(rules.numpy())) == {0.0, 1.0} and abs(rules.mean().item() - 0.5) < 0.05
    plain = ema_view_3d(img, ema_generator(0, 0, "cpu"), intensity=False, mask=False, flip=False)
    assert torch.equal(plain[0], img) and not plain[1].any()


def test_pni_batchnorm_running_stats_match_flax():
    """Train-mode forward: the running statistics as Flax's
    ``mutable=["batch_stats"]`` gives them (biased batch variance, Flax
    momentum 0.999); torch's stock BatchNorm3d is off by the n/(n-1)
    factor."""
    filters = (4, 6, 8, 12, 16)
    model = FlaxPNI(filters=filters, emd=8)
    x = np.random.default_rng(17).random((2, 4, 32, 32, 1)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x[:1], train=False))
    rng = np.random.default_rng(18)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * (0.3 if "kernel" in name else 0.1)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    _, mut = jax.jit(lambda v, a: model.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, x)
    exp = unet_pni_deep_from_flax({"params": variables["params"],
                                   "batch_stats": jax.device_get(mut["batch_stats"])})
    port = UNetPNIEmbeddingDeep(1, filters, 8)
    port.load_state_dict(unet_pni_deep_from_flax(variables))
    stock = copy.deepcopy(port)
    for mod in stock.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.__class__ = torch.nn.BatchNorm3d
    with torch.no_grad():
        port.train()(T(x).permute(0, 4, 1, 2, 3))
        stock.train()(T(x).permute(0, 4, 1, 2, 3))
    got, off = port.state_dict(), stock.state_dict()
    # measured: the port within 1.2e-7, the stock module up to 1.6e-5 off
    # (the center block's 32 voxels a channel)
    stock_ok = True
    for k, v in exp.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
            stock_ok &= np.allclose(off[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)
    assert not stock_ok  # the same check refuses torch's stock BatchNorm3d
