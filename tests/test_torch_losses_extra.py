"""The port's ablation losses, superpixel ops, deep-supervision losses and
host targets against the JAX package's, on the CPU.

Losses and affinities within 1e-5 of the largest JAX value, gradients
within 1e-4 of the largest ``jax.grad`` value, at B=2 and 32x32 to 48x48
(3D: 8x32x32), JAX at ``highest`` precision (tests/conftest.py). The host
targets (``shift_channels_offsets``, ``gen_affs_mutex_3d``,
``remove_small``, ``seg_to_instance_bd``, ``weight_unet2d/3d``) are numpy
and bit-equal. ``instance_neighbor_lists`` is equal, warnings and errors
included. The reference's quirks that the JAX package keeps are kept
(``local_embedding_loss``'s ``+ 1e12`` and the sign of its inner term)."""

import os
import warnings

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.ops import affinity_np as jax_np
from pixel_embedded_affinity_tpu.ops import losses as jax_losses
from pixel_embedded_affinity_tpu.ops import losses_extra as jax_extra
from pixel_embedded_affinity_tpu.ops import offsets as jax_offsets
from pixel_embedded_affinity_tpu.ops import spixel as jax_spixel

from pixel_embedded_affinity_torch.ops import affinity_np, losses, losses_extra, offsets, spixel
from pixel_embedded_affinity_torch.ops import multi_offset

from synth import blob_labels

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
OFFSETS_2D = multi_offset([1, 3, 5, 9, 27], 4)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _seg2d(b, h, w, seed):
    return np.stack([blob_labels(h, w, grid=3, radius=max(h // 8, 3), seed=seed + i)
                     for i in range(b)]).astype(np.int32)


def _check(port_fn, jax_fn, args, grad_index=0):
    """The port's scalar fn(*args) and its gradient in args[grad_index]
    against JAX's, args given as numpy. The loss is held against JAX's
    function run in float64 (``jax.enable_x64``): JAX's own float32 sum
    of ~1e5 terms on the CPU is up to 6.4e-5 off its float64 value (the
    norm6 case), the port's 1e-7. The port in float64 equals JAX in
    float64 to 1e-10, the same function."""
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    targs[grad_index] = targs[grad_index].clone().requires_grad_(True)
    out = port_fn(*targs)
    out.backward()
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]

    def jfn(x, a=jargs):
        return jax_fn(*a[:grad_index], x, *a[grad_index + 1:])

    ref_grad = jax.grad(jfn)(jargs[grad_index])
    assert _rel(targs[grad_index].grad.numpy(), ref_grad) <= GRAD_RTOL
    with jax.enable_x64():
        a64 = [jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
               if isinstance(a, np.ndarray) else a for a in args]
        ref64 = float(jfn(a64[grad_index], a64))
    assert _rel(out.detach().numpy(), ref64) <= LOSS_RTOL
    t64 = [torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32 else a)
           if isinstance(a, np.ndarray) else a for a in args]
    with torch.no_grad():
        assert _rel(port_fn(*t64).numpy(), ref64) <= 1e-10


def _check_affs(port_fn, jax_fn, e, seed):
    """Affinities fn(e) against JAX's within 1e-5 of the largest, and the
    gradient of their sum weighted by a fixed random cotangent within 1e-4
    of the largest (the weighted sum itself cancels to a small number, so
    it is no yardstick of a relative error)."""
    te = torch.from_numpy(e).requires_grad_(True)
    ours = port_fn(te)
    ref = jax_fn(jnp.asarray(e))
    assert _rel(ours.detach().numpy(), ref) <= LOSS_RTOL
    cot = _rand(ref.shape, seed)
    ours.backward(torch.from_numpy(cot))
    grad = jax.grad(lambda x: jnp.sum(jax_fn(x) * cot))(jnp.asarray(e))
    assert _rel(te.grad.numpy(), grad) <= GRAD_RTOL


# ---- host targets

@pytest.mark.parametrize("n", [3, 7, 9, 15, 17, 23])
def test_shift_channels_offsets_match_jax(n):
    assert offsets.shift_channels_offsets(n) == jax_offsets.shift_channels_offsets(n)


def test_shift_channels_offsets_refuse_unknown():
    with pytest.raises(NotImplementedError):
        offsets.shift_channels_offsets(5)


def _vol(seed, d=6, h=40, w=44):
    return np.stack([blob_labels(h, w, grid=3, radius=6, seed=seed + z) for z in range(d)])


@pytest.mark.parametrize("padding,background", [(True, False), (False, False), (True, True)])
def test_gen_affs_mutex_3d_matches_jax(padding, background):
    seg = _vol(1)
    offs = offsets.shift_channels_offsets(23)
    np.testing.assert_array_equal(
        affinity_np.gen_affs_mutex_3d(seg, offs, padding, background),
        jax_np.gen_affs_mutex_3d(seg, offs, padding, background))


def test_remove_small_and_instance_boundaries_match_jax():
    seg = _vol(2).astype(np.int64)
    np.testing.assert_array_equal(affinity_np.remove_small(seg.copy(), 120),
                                  jax_np.remove_small(seg.copy(), 120))
    for do_bg in (False, True):
        np.testing.assert_array_equal(affinity_np.seg_to_instance_bd(seg, 3, do_bg),
                                      jax_np.seg_to_instance_bd(seg, 3, do_bg))
        np.testing.assert_array_equal(affinity_np.seg_to_instance_bd(seg[0], 2, do_bg),
                                      jax_np.seg_to_instance_bd(seg[0], 2, do_bg))


def test_unet_weights_match_jax():
    seg = _vol(3, d=3, h=32, w=36)
    seg[1] = 0
    one = np.zeros((20, 24), np.int64)
    one[4:12, 5:15] = 3
    np.testing.assert_array_equal(affinity_np.weight_unet2d(seg[0]), jax_np.weight_unet2d(seg[0]))
    np.testing.assert_array_equal(affinity_np.weight_unet2d(one, 5.0, 3.0),
                                  jax_np.weight_unet2d(one, 5.0, 3.0))
    np.testing.assert_array_equal(affinity_np.weight_unet3d(seg), jax_np.weight_unet3d(seg))


# ---- the 2D ablation losses

@pytest.mark.parametrize("clamp", [True, False])
def test_cosine_affinity_matches_jax(clamp):
    _check_affs(lambda x: losses_extra.cosine_affinity_2d(x, OFFSETS_2D, clamp=clamp),
                lambda x: jax_extra.cosine_affinity_2d(x, OFFSETS_2D, clamp=clamp),
                _rand((2, 32, 40, 16), 4), 5)


def test_distance_and_rescaled_affinities_match_jax():
    """Where the replication-pad neighbour is the pixel itself (the border
    rows and columns an offset clamps), |e - e'| = 0 and jnp.linalg.norm's
    gradient is NaN in JAX; torch's norm takes the 0 subgradient there, as
    the reference's torch.norm does, so the port's gradient is finite
    everywhere and equals JAX's wherever JAX's is finite."""
    e = _rand((2, 36, 32, 16), 6)
    cot = _rand((2, 10, 36, 32), 7)
    te = torch.from_numpy(e).requires_grad_(True)
    ours = losses_extra.embeddings_to_affinities_distance(te, OFFSETS_2D)
    ref = jax_extra.embeddings_to_affinities_distance(jnp.asarray(e), OFFSETS_2D)
    assert _rel(ours.detach().numpy(), ref) <= LOSS_RTOL
    ours.backward(torch.from_numpy(cot))
    grad = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_extra.embeddings_to_affinities_distance(x, OFFSETS_2D) * cot))(jnp.asarray(e)))
    finite = np.isfinite(grad).all(axis=-1)
    assert np.isfinite(te.grad.numpy()).all()
    # JAX's NaNs lie exactly on the pixels that some offset clamps onto themselves
    h, w = e.shape[1:3]
    yy, xx = np.mgrid[0:h, 0:w]
    clamped = np.zeros((h, w), bool)
    for oy, ox in OFFSETS_2D:
        clamped |= (np.clip(yy + oy, 0, h - 1) == yy) & (np.clip(xx + ox, 0, w - 1) == xx)
    np.testing.assert_array_equal(~finite, np.broadcast_to(clamped, finite.shape))
    assert _rel(te.grad.numpy()[finite], grad[finite]) <= GRAD_RTOL
    a = _rand((2, 10, 36, 32), 8)
    np.testing.assert_array_equal(losses_extra.rescaled_affinity(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax_extra.rescaled_affinity(jnp.asarray(a))))


@pytest.mark.parametrize("mode", ["cos", "l2"])
def test_orthogonal_loss_matches_jax(mode):
    e = _rand((2, 40, 36, 16), 9)
    seg = _seg2d(2, 40, 36, 10)
    affs, mask = zip(*[jax_np.gen_affs(s, OFFSETS_2D, padding=True) for s in seg])
    target, mask = np.stack(affs), np.stack(mask).astype(np.float32)
    weight = np.stack([jax_np.weight_binary_ratio(a) for a in target]).astype(np.float32)
    tt, tw, tm = (torch.from_numpy(x) for x in (target, weight, mask))
    _check(lambda x: losses_extra.embedding_loss_orthogonal(
               x, tt, tw, tm, losses.weighted_mse, OFFSETS_2D, 2.0, mode)[0],
           lambda x: jax_extra.embedding_loss_orthogonal(
               x, target, weight, mask, jax_losses.weighted_mse, OFFSETS_2D, 2.0, mode)[0], [e])


@pytest.mark.parametrize("b,h,w", [(2, 32, 32), (2, 48, 40)])
@pytest.mark.parametrize("include_background", [True, False])
def test_discriminative_loss_matches_jax(b, h, w, include_background):
    e = _rand((b, h, w, 16), 11)
    seg = _seg2d(b, h, w, 12)
    _check(lambda x, s: losses_extra.discriminative_loss(
               x, s, 16, include_background=include_background),
           lambda x, s: jax_extra.discriminative_loss(
               x, s, 16, include_background=include_background), [e, seg])


@pytest.mark.parametrize("include_bg,norm", [(True, True), (False, True), (True, False)])
def test_local_embedding_loss_matches_jax(include_bg, norm):
    e = _rand((2, 32, 36, 8), 13)
    seg = _seg2d(2, 32, 36, 14)
    n_rows = int(seg.max())
    neigh = np.stack([jax_extra.instance_neighbor_lists(s, n_rows, 8) for s in seg])
    _check(lambda x, s, n: losses_extra.local_embedding_loss(x, s, n, include_bg, norm),
           lambda x, s, n: jax_extra.local_embedding_loss(x, s, n, include_bg, norm),
           [e, seg, neigh])


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("n_rows,m,dilate", [(9, 8, 1), (9, 1, 2), (4, 8, 1)],
                         ids=["fits", "rows-full", "labels-over"])
def test_instance_neighbor_lists_match_jax(n_rows, m, dilate):
    seg = _seg2d(1, 40, 40, 15)[0]
    ours, our_w = _warned(lambda: losses_extra.instance_neighbor_lists(seg, n_rows, m, dilate))
    theirs, their_w = _warned(lambda: jax_extra.instance_neighbor_lists(seg, n_rows, m, dilate))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.dtype == theirs.dtype
    assert our_w == their_w
    if their_w:
        with pytest.raises(ValueError) as ours_err:
            losses_extra.instance_neighbor_lists(seg, n_rows, m, dilate, strict=True)
        with pytest.raises(ValueError) as theirs_err:
            jax_extra.instance_neighbor_lists(seg, n_rows, m, dilate, strict=True)
        assert str(ours_err.value) == str(theirs_err.value)


def test_deep_supervision_losses_match_jax():
    b, h = 2, 64
    embs = [_rand((b, h >> (k + 1), h >> (k + 1), 16), 16 + k) for k in range(4)]
    downs = []
    for k in range(4):
        n_off = 2 * (4 - k)
        side = h >> (k + 1)
        segs = _seg2d(b, side, side, 20 + k)
        affs, mask = zip(*[jax_np.gen_affs(s, OFFSETS_2D[:n_off], padding=True) for s in segs])
        affs = np.stack(affs)
        weight = np.stack([jax_np.weight_binary_ratio(a) for a in affs])
        downs.append(np.concatenate([affs, weight, np.stack(mask)], axis=1).astype(np.float32))
    tdowns = [torch.from_numpy(d) for d in downs]
    tembs = [torch.from_numpy(e).requires_grad_(True) for e in embs]
    for use_pallas in (False, True):  # on CPU tensors the kernel wrappers run the plain versions
        for t in tembs:
            t.grad = None
        ours = losses.deep_supervision_losses_2d(tembs, tdowns, OFFSETS_2D, 4,
                                                 use_pallas=use_pallas)
        ours.backward()
        ref, grads = jax.value_and_grad(lambda es: jax_losses.deep_supervision_losses_2d(
            es, [jnp.asarray(d) for d in downs], OFFSETS_2D, 4, use_pallas=False))(
            [jnp.asarray(e) for e in embs])
        assert _rel(ours.detach().numpy(), ref) <= LOSS_RTOL
        for t, g in zip(tembs, grads):
            assert _rel(t.grad.numpy(), g) <= GRAD_RTOL


# ---- norm6 (3D, arbitrary offsets)

@pytest.mark.parametrize("ema", [False, True])
def test_norm6_loss_matches_jax(ema):
    e = _rand((2, 8, 32, 32, 16), 30)
    ema_e = _rand((2, 8, 32, 32, 16), 31) if ema else None
    offs = offsets.shift_channels_offsets(9)
    seg = _vol(32, d=8, h=32, w=32)
    target = np.stack([jax_np.gen_affs_mutex_3d(seg, offs)] * 2).astype(np.float32)
    weight = np.stack([jax_np.weight_binary_ratio(t) for t in target]).astype(np.float32)
    tt, tw = torch.from_numpy(target), torch.from_numpy(weight)
    # the EMA embedding is an argument, so that _check's float64 runs take
    # it in float64 too: held in the closures as float32, both packages
    # normalised it in float32 and their float64 losses parted by 2.4e-10
    # (the port 1.6e-10, JAX 7.8e-11 off numpy's float64 loss, measured)
    _check(lambda x, *m: losses_extra.embedding_loss_norm6(
               x, tt, tw, losses.weighted_mse, offs, ema_embedding=m[0] if m else None)[0],
           lambda x, *m: jax_extra.embedding_loss_norm6(
               x, target, weight, jax_losses.weighted_mse, offs,
               ema_embedding=m[0] if m else None)[0],
           [e] if ema_e is None else [e, ema_e])


def test_norm6_affinities_match_jax():
    offs = offsets.shift_channels_offsets(23)
    _check_affs(lambda x: losses_extra.affinity_norm6_3d(x, offs),
                lambda x: jax_extra.affinity_norm6_3d(x, offs), _rand((1, 6, 20, 24, 8), 33), 34)
    for mode in ("cos", "l2"):
        _check_affs(lambda x: losses_extra.orthogonal_affinity_2d(x, OFFSETS_2D, mode),
                    lambda x: jax_extra.orthogonal_affinity_2d(x, OFFSETS_2D, mode),
                    _rand((2, 32, 36, 16), 35), 36)


# ---- superpixels (the port NCHW, JAX NHWC)

def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def _prob(b, h, w, seed):
    p = np.random.default_rng(seed).random((b, 9, h, w)).astype(np.float32)
    return p / p.sum(axis=1, keepdims=True)


def test_poolfeat_and_upfeat_match_jax():
    feat = _rand((2, 5, 32, 48), 40)
    prob = _prob(2, 32, 48, 41)
    pooled = spixel.poolfeat(torch.from_numpy(feat), torch.from_numpy(prob), 4, 4)
    ref = jax_spixel.poolfeat(jnp.asarray(_nhwc(feat)), jnp.asarray(_nhwc(prob)), 4, 4)
    assert _rel(_nhwc(pooled.numpy()), ref) <= LOSS_RTOL
    up = spixel.upfeat(pooled, torch.from_numpy(prob), 4, 4)
    ref_up = jax_spixel.upfeat(ref, jnp.asarray(_nhwc(prob)), 4, 4)
    assert _rel(_nhwc(up.numpy()), ref_up) <= LOSS_RTOL
    with pytest.raises(ValueError):
        spixel.poolfeat(torch.from_numpy(feat[..., :47]), torch.from_numpy(prob[..., :47]), 4, 4)


def test_semantic_pos_loss_matches_jax():
    b, h, w, s = 2, 48, 32, 8
    seg = _seg2d(b, h, w, 42)
    onehot = np.eye(seg.max() + 1, dtype=np.float32)[seg]                # (B, H, W, L)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xy = np.broadcast_to(np.stack([xx, yy], -1)[None] / s, (b, h, w, 2)).astype(np.float32)
    labxy = np.concatenate([onehot, xy], axis=-1)
    logits = _rand((b, 9, h, w), 43)
    tl = torch.from_numpy(logits).requires_grad_(True)
    ours = spixel.compute_semantic_pos_loss(torch.softmax(tl, dim=1),
                                            torch.from_numpy(np.moveaxis(labxy, -1, 1).copy()),
                                            kernel_size=s)
    ours[0].backward()

    def jax_loss(lg):
        return jax_spixel.compute_semantic_pos_loss(jax.nn.softmax(lg, axis=-1),
                                                    jnp.asarray(labxy), kernel_size=s)

    ref = jax_loss(jnp.asarray(_nhwc(logits)))
    for o, r in zip(ours, ref):
        assert _rel(o.detach().numpy(), r) <= LOSS_RTOL
    grad = jax.grad(lambda lg: jax_loss(lg)[0])(jnp.asarray(_nhwc(logits)))
    assert _rel(_nhwc(tl.grad.numpy()), grad) <= GRAD_RTOL
