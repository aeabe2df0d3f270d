"""What the tensor-core redesign of K8 and the K7/K9 conv kernel rests on,
held on the CPU (the kernels themselves run only on the card):

* ``direct_taps`` inverts the 2x2 parity taps, the port's ``block_taps``
  and the JAX package's ``s2d_conv2x2_weights``, bit for bit, and its
  structure check refuses parity taps that are not gathers of 3x3 taps;
* the s2d <-> direct address map that ``csrc/s2d_block.cu`` reads and
  writes through equals ``depth_to_space``;
* the 3xTF32 split, emulated in numpy with the tensor cores' TF32 rounding
  and float32 accumulation, is float32-class at K8's deepest K, where one
  TF32 pass is not: the reason the float32 path runs three passes;
* the pallas stage form's precomputed direct taps are the block's folded
  direct weights;
* a library's name changes with any shared header it may include.
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

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.ops.s2d import s2d_conv2x2_weights as jax_s2d_conv2x2_weights

from pixel_embedded_affinity_torch import cuda_build
from pixel_embedded_affinity_torch.models import fast_forward as ff
from pixel_embedded_affinity_torch.models.resunet2d import ResidualBlock
from pixel_embedded_affinity_torch.ops import s2d_block_cuda as sb
from pixel_embedded_affinity_torch.ops.s2d import depth_to_space


def _weights(rng, ci, c):
    w1, wp = ((rng.normal(size=(3, 3, ci, c)) * 0.2).astype(np.float32) for _ in range(2))
    w2 = (rng.normal(size=(3, 3, c, c)) * 0.2).astype(np.float32)
    h1, hp, h2 = (rng.normal(size=(c,)).astype(np.float32) for _ in range(3))
    return w1, wp, w2, h1, hp, h2


def _taps(c, split, seed=0):
    arrs = _weights(np.random.default_rng(seed), 12, c)
    return arrs, sb.block_taps(*(torch.from_numpy(a) for a in arrs), split)


@pytest.mark.parametrize("split", [None, 5])
@pytest.mark.parametrize("c", [16, 32])
def test_direct_taps_inverts_block_taps_bit_for_bit(c, split):
    (w1, wp, w2, h1, hp, h2), (k1ps, h1p, k2, h2t) = _taps(c, split)
    d = sb.direct_taps(k1ps, h1p, k2, h2t, c, c, c)
    w1p = np.concatenate([w1, wp], 3)
    want = [w1p] if split is None else [w1p[:, :, :split], w1p[:, :, split:]]
    assert len(d.w1p) == len(want)
    for got, ref in zip(d.w1p, want):
        assert got.numpy().tobytes() == np.ascontiguousarray(ref).tobytes()
    assert d.w2.numpy().tobytes() == w2.tobytes()
    for got, ref in ((d.h1, h1), (d.hp, hp), (d.h2, h2)):
        assert got.dtype == torch.float32 and got.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("c", [16, 32])
def test_direct_taps_inverts_jax_parity_taps(c):
    w1, _, w2, _, _, _ = _weights(np.random.default_rng(1), 8, c)
    k2 = torch.from_numpy(np.array(jax_s2d_conv2x2_weights(jnp.asarray(w2))))
    k1 = torch.from_numpy(np.array(jax_s2d_conv2x2_weights(jnp.asarray(w1))))
    assert sb._direct_from_parity(k2, c, "k2").numpy().tobytes() == w2.tobytes()
    assert sb._direct_from_parity(k1, c, "k1").numpy().tobytes() == w1.tobytes()


# (name, what to perturb, the error's words); k1p is (2, 2, 4 * 12, 4 * 32):
# [by, bx, (py, px, ci), (qy, qx, [c1 | cp])]
_PERTURB = [
    # by = py = qy = 0: tap index -1, a structural zero
    ("structural zero", lambda t: t[0].__setitem__((0, 0, 0, 0), 0.5), "structural zero"),
    # by = bx = 1, py = px = 1, qy = qx = 1: tap index 3, a structural zero
    ("last structural zero", lambda t: t[0].__setitem__((1, 1, 47, 127), 0.5), "structural zero"),
    # by = bx = 0, (py, px) = (1, 1), (qy, qx) = (0, 0): one copy of w[0, 0]
    ("one copy", lambda t: t[0].__setitem__((0, 0, 36, 0), t[0][0, 0, 36, 0] + 1e-3), "differ"),
    ("conv2 copy", lambda t: t[2].__setitem__((1, 1, 0, 0), t[2][1, 1, 0, 0] * 2 + 1), "differ"),
    ("shift copy", lambda t: t[1].__setitem__(40, t[1][40] + 1), "copies"),
]


@pytest.mark.parametrize("name,perturb,words", _PERTURB, ids=[p[0] for p in _PERTURB])
def test_direct_taps_rejects_taps_off_the_3x3_structure(name, perturb, words):
    _, (k1ps, h1p, k2, h2t) = _taps(16, None, seed=2)
    sb.direct_taps(k1ps, h1p, k2, h2t, 16, 16, 16)  # block_taps' output passes
    taps = [k1ps.clone(), h1p.clone(), k2.clone()]
    perturb(taps)
    with pytest.raises(ValueError, match=words):
        sb.direct_taps(taps[0], taps[1], taps[2], h2t, 16, 16, 16)


def test_direct_taps_rejects_wrong_shapes():
    _, (k1ps, h1p, k2, h2t) = _taps(16, None)
    with pytest.raises(ValueError, match="parity taps must be"):
        sb.direct_taps(k1ps[:, :, :-1], h1p, k2, h2t, 16, 16, 16)


@pytest.mark.parametrize("shape", [(2, 3, 5, 8), (1, 4, 4, 12), (1, 1, 7, 4)])
def test_s2d_address_map_is_depth_to_space(shape):
    b, h, w, c4 = shape
    k = c4 // 4
    x = torch.arange(b * h * w * c4, dtype=torch.float32).reshape(shape)
    y, xx, c = torch.meshgrid(torch.arange(2 * h), torch.arange(2 * w), torch.arange(k),
                              indexing="ij")
    g, u, ch = sb.s2d_address(y, xx, c, k)
    assert torch.equal(x[:, g, u, ch], depth_to_space(x))
    assert sb.s2d_address(3, 2, 1, k) == (1, 1, 2 * k + 1)


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_passes_are_float32_class_at_k8_depth(seed):
    """The tensor cores multiply TF32 operands exactly and accumulate in
    float32, which a float32 product emulates; K = 9 x 192, up3's conv1
    depth. One pass rounds each operand to ~2^-11 and lands ~3e-4 off
    float64 (relative to the largest output); three passes, a_lo b_hi +
    a_hi b_lo + a_hi b_hi summed into one accumulator, ~4e-7, within
    chip_smoke's 1e-5 gate with room to spare."""
    rng = np.random.default_rng(seed)
    k = 9 * 192
    a = rng.normal(size=(64, k)).astype(np.float32)
    b = (rng.normal(size=(k, 64)) / np.sqrt(k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    one = a_hi @ b_hi
    three = np.concatenate([a_lo, a_hi, a_hi], 1) @ np.concatenate([b_hi, b_lo, b_hi], 0)
    top = np.abs(ref).max()
    assert np.abs(three - ref).max() / top <= 1e-6
    assert np.abs(one - ref).max() / top > 1e-5
    # the split is exact to ~2^-22: hi + lo recovers a to float32 rounding
    assert np.abs((a_hi.astype(np.float64) + a_lo) - a).max() <= 2.0 ** -21 * np.abs(a).max()


@pytest.mark.parametrize("split", [None, 4])
def test_pallas_form_direct_taps_are_the_folded_weights(split):
    rng = np.random.default_rng(5)
    block = ResidualBlock(6, 16)
    with torch.no_grad():
        for mod in block.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, 16)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 16)))
    block.eval()
    pal = ff._BlockW(block, torch.float32, "pallas", split_at=split)
    direct = ff._BlockW(block, torch.float32, False, split_at=split)
    w1p = direct.w1p if split is not None else (direct.w1p,)
    for got, ref in zip(pal.direct.w1p, w1p):
        assert torch.equal(got, ref.permute(2, 3, 1, 0))
    assert torch.equal(pal.direct.w2, direct.w2.permute(2, 3, 1, 0))
    assert torch.equal(torch.cat([pal.direct.h1, pal.direct.hp]), direct.h1p)
    assert torch.equal(pal.direct.h2, direct.h2)


def test_library_path_changes_with_a_shared_header(tmp_path):
    csrc = str(tmp_path / "csrc")
    shutil.copytree(cuda_build.CSRC, csrc)
    headers = [f for f in os.listdir(csrc) if f.endswith(".cuh")]
    assert headers, "the kernels share a header"
    first = {s: cuda_build.library_path(s, csrc) for s in ("conv3x3.cu", "s2d_block.cu")}
    assert first["conv3x3.cu"] == cuda_build.library_path("conv3x3.cu")
    with open(os.path.join(csrc, headers[0]), "a") as f:
        f.write("\n// changed\n")
    for s, path in first.items():
        changed = cuda_build.library_path(s, csrc)
        assert changed != path and os.path.basename(changed).startswith(f"lib{s[:-3]}-")
    with open(os.path.join(csrc, "tile_copy.cu"), "a") as f:
        f.write("\n")
    assert cuda_build.library_path("tile_copy.cu", csrc) != cuda_build.library_path(
        "tile_copy.cu")
