"""The plain versions of the port's conv kernels against the JAX package's
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU: K7 (``conv3x3_fused``), K9a (``conv3x3_blocked``), K9b
(``conv3x3_blocked_flat``, chained by ``conv3x3_blocked_chain``) and K8
(``fused_s2d_block``). The same numpy inputs go to both; tolerances are the
JAX tests' own (the two sum the taps in another order). On these CPU
tensors the wrappers run the plain versions and count no launch."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.ops import conv3x3_blocked as jax_blocked
from pixel_embedded_affinity_tpu.ops.conv3x3_pallas import conv3x3_fused as jax_fused
from pixel_embedded_affinity_tpu.ops.s2d import (
    s2d_conv2x2_weights as jax_s2d_conv2x2_weights, space_to_depth as jax_space_to_depth)
from pixel_embedded_affinity_tpu.ops.s2d_block_pallas import fused_s2d_block as jax_block

from pixel_embedded_affinity_torch.ops import conv3x3_cuda as cc
from pixel_embedded_affinity_torch.ops import s2d_block_cuda as sb
from pixel_embedded_affinity_torch.ops.s2d import space_to_depth


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32),
            rng.normal(size=(cout,)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape", [
    (2, 12, 10, 5, 7),     # odd sizes
    (1, 20, 16, 300, 9),   # Cin > 256: the JAX kernel's chunked path
    (1, 33, 15, 3, 16),    # RGB-like
])
def test_conv3x3_fused_plain_matches_jax(shape):
    """atol 2e-5, the JAX test's, times the largest output where that
    exceeds 1: at Cin=300 each output sums 2700 products and reaches ~16,
    and the two packages' sums, in other orders, part by ~4e-6 of that
    (float32 rounding, 5.7e-5 absolute)."""
    x, w, sc, sh = _inputs(0, *shape)
    ref = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                               jnp.asarray(sh), relu=True, tile_h=4, interpret=True))
    before = cc.conv3x3_fused.launches
    got = cc.conv3x3_fused(*_t(x, w, sc, sh), relu=True)
    assert cc.conv3x3_fused.launches == before
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * max(1.0, np.abs(ref).max()))


def test_conv3x3_fused_plain_no_epilogue_matches_jax():
    x, w, _, _ = _inputs(1, 1, 16, 16, 8, 8)
    ref = jax_fused(jnp.asarray(x), jnp.asarray(w), tile_h=8, interpret=True)
    got = cc.conv3x3_fused(*_t(x, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 32), (192, 64)])
def test_conv3x3_blocked_plain_matches_jax(cin, cout):
    x, w, sc, sh = _inputs(cin * 1000 + cout, 2, 33, 40, cin, cout)
    ref = jax_blocked.conv3x3_blocked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                                      jnp.asarray(sh), relu=True, tile_h=8, interpret=True)
    before = cc.conv3x3_blocked.launches
    got = cc.conv3x3_blocked(*_t(x, w, sc, sh), relu=True)
    assert cc.conv3x3_blocked.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("c,k", [(16, 2), (64, 3)])
def test_conv3x3_blocked_chain_plain_matches_jax(c, k):
    rng = np.random.default_rng(c + k)
    x = rng.normal(size=(2, 21, 26, c)).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32) for _ in range(k)]
    scs = [rng.normal(size=(c,)).astype(np.float32) for _ in range(k)]
    shs = [rng.normal(size=(c,)).astype(np.float32) for _ in range(k)]
    ref = jax_blocked.conv3x3_blocked_chain(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(s) for s in scs],
        [jnp.asarray(s) for s in shs], relu=True, interpret=True)
    got = cc.conv3x3_blocked_chain(torch.from_numpy(x), _t(*ws), _t(*scs), _t(*shs), relu=True)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


def test_conv3x3_blocked_flat_step_matches_jax_canvas():
    """One K9b step on the JAX blocked stream's own canvas: the same
    (B, alloc, wp, C) NHWC canvas out, the image moved up-left by one and
    every other element exactly 0."""
    c, h, wd, top, left = 16, 13, 11, 16, 3
    x, w, sc, sh = _inputs(9, 2, h, wd, c, c)
    flat, g = jax_blocked.blocked_ingest(jnp.asarray(x), top=top, left=left, tile_h=16)
    out = jax_blocked.conv3x3_blocked_flat(flat, jnp.asarray(w), g, top, left,
                                           jnp.asarray(sc), jnp.asarray(sh), relu=True,
                                           interpret=True)
    # the JAX stream's last tile_h rows are halo slack its grid never writes
    ref = np.asarray(out).reshape(g.b, g.alloc, g.wp, g.cc)[:, :g.hp]
    canvas = torch.from_numpy(np.asarray(flat).reshape(g.b, g.alloc, g.wp, g.cc).copy())
    geom = cc.CanvasGeom(g.b, h, wd, c, g.alloc, g.wp)
    got = cc.conv3x3_blocked_flat(canvas, *_t(w), geom, top, left, *_t(sc, sh), relu=True)
    assert got.shape == (g.b, g.alloc, g.wp, g.cc)
    np.testing.assert_allclose(got[:, :g.hp].numpy(), ref, atol=2e-4)
    outside = got.clone()
    outside[:, top - 1:top - 1 + h, left - 1:left - 1 + wd] = 0
    assert bool((outside == 0).all())
    np.testing.assert_allclose(
        cc.blocked_egress(got, geom, top - 1, left - 1).numpy(),
        cc.conv3x3_plain(*_t(x, w, sc, sh), relu=True).numpy(), atol=1e-5)


def test_conv3x3_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8, 4)
    canvas, g = cc.blocked_ingest(x, 2, 2)
    with pytest.raises(ValueError, match="C -> C"):
        cc.conv3x3_blocked_flat(canvas, torch.zeros(3, 3, 4, 8), g, 2, 2)
    with pytest.raises(ValueError, match="zero border"):
        cc.conv3x3_blocked_flat(canvas, torch.zeros(3, 3, 4, 4), g, 0, 2)
    with pytest.raises(ValueError, match="place"):
        cc.blocked_ingest(x, -1, 2)
    assert canvas.shape == (1, 11, 11, 4) and bool((canvas == 0).all())
    with pytest.raises(ValueError, match="CUDA"):
        cc._launch(x, torch.zeros(3, 3, 4, 4), None, None, False, 1, (0, 8, 0, 8))


def _jax_fuse_full(wa, wb):
    ka, kb = jax_s2d_conv2x2_weights(wa), jax_s2d_conv2x2_weights(wb)
    k = jnp.concatenate([ka.reshape(2, 2, ka.shape[2], 4, -1),
                         kb.reshape(2, 2, kb.shape[2], 4, -1)], -1)
    return k.reshape(2, 2, ka.shape[2], -1)


@pytest.mark.parametrize("split", [None, 4])
def test_fused_s2d_block_plain_matches_jax(split):
    rng = np.random.default_rng(2)
    ci, co, h, w = 10, 8, 32, 16
    w1, wp = ((rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32) for _ in range(2))
    w2 = (rng.normal(size=(3, 3, co, co)) * 0.2).astype(np.float32)
    h1, hp, h2 = (rng.normal(size=(co,)).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(2, h, w, ci)).astype(np.float32)
    h1p, h2t = np.tile(np.concatenate([h1, hp]), 4), np.tile(h2, 4)
    cuts = [(0, ci)] if split is None else [(0, split), (split, ci)]
    jxs = tuple(jax_space_to_depth(jnp.asarray(x[..., a:b])) for a, b in cuts)
    jks = tuple(_jax_fuse_full(jnp.asarray(w1[:, :, a:b]), jnp.asarray(wp[:, :, a:b]))
                for a, b in cuts)
    ref = jax_block(jxs, jks, jnp.asarray(h1p), jax_s2d_conv2x2_weights(jnp.asarray(w2)),
                    jnp.asarray(h2t), co, co, co, tile_h=4, interpret=True)
    xs = tuple(space_to_depth(torch.from_numpy(x[..., a:b])) for a, b in cuts)
    k1ps, th1p, k2, th2 = sb.block_taps(*_t(w1, wp, w2, h1, hp, h2), split)
    np.testing.assert_array_equal(th1p.numpy(), h1p)
    np.testing.assert_array_equal(th2.numpy(), h2t)
    for k, jk in zip(k1ps if split else (k1ps,), jks):
        assert k.numpy().tobytes() == np.asarray(jk).tobytes()
    before = sb.fused_s2d_block.launches
    got = sb.fused_s2d_block(xs if split else xs[0], k1ps, th1p, k2, th2, co, co, co)
    assert sb.fused_s2d_block.launches == before
    assert got.shape == (2, h // 2, w // 2, 4 * co)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_fused_s2d_block_plain_zero_ring():
    """The y1 ring outside the image is 0, not relu(shift): a block whose
    conv1 shift is large and whose input is zero gives relu(conv2 of the
    interior's constant y1 + h2 + hp), which differs at the border."""
    c = 4
    w1 = torch.zeros(3, 3, 2, c)
    wp = torch.zeros(3, 3, 2, c)
    w2 = torch.ones(3, 3, c, c) * 0.1
    h1, hp, h2 = torch.full((c,), 5.0), torch.zeros(c), torch.zeros(c)
    x = torch.zeros(1, 3, 4, 8)
    out = sb.fused_s2d_block(x, *sb.block_taps(w1, wp, w2, h1, hp, h2), c, c, c)
    full = out.reshape(1, 3, 4, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(1, 6, 8, c)
    # interior pixels see 9 taps of y1 = 5, corners 4, edges 6
    assert torch.allclose(full[0, 2, 3], torch.full((c,), 9 * c * 0.5))
    assert torch.allclose(full[0, 0, 0], torch.full((c,), 4 * c * 0.5))
    assert torch.allclose(full[0, 0, 3], torch.full((c,), 6 * c * 0.5))


def test_fused_s2d_block_rejects_unsupported_widths():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="c1, c2"):
        sb._check((x,), (torch.zeros(2, 2, 8, 4 * 16),), torch.zeros(64), torch.zeros(2, 2, 32, 32),
                  torch.zeros(32), 8, 8, 8)
