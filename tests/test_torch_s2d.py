"""The port's space-to-depth rearrangements and weight transforms
(``pixel_embedded_affinity_torch/ops/s2d.py``) against the JAX package's
``ops/s2d.py``: the same numpy inputs, bit-equal outputs (every function is
a gather of its input, so no rounding can differ)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.models.fast_forward import pack_image_s2d as jax_pack
from pixel_embedded_affinity_tpu.ops import s2d as jax_s2d

from pixel_embedded_affinity_torch.models.fast_forward import pack_image_s2d
from pixel_embedded_affinity_torch.ops import s2d


def _both(fn_name, arr, *args):
    ours = getattr(s2d, fn_name)(torch.from_numpy(arr), *args).numpy()
    theirs = np.asarray(getattr(jax_s2d, fn_name)(jnp.asarray(arr), *args))
    return ours, theirs


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 16, 10, 5)])
def test_space_to_depth_and_back_match_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ours, theirs = _both("space_to_depth", x)
    assert ours.tobytes() == theirs.tobytes() and ours.shape == theirs.shape
    back, theirs_back = _both("depth_to_space", ours)
    assert back.tobytes() == theirs_back.tobytes()
    np.testing.assert_array_equal(back, x)


def test_space_to_depth_rejects_odd_sizes():
    with pytest.raises(ValueError):
        s2d.space_to_depth(torch.zeros(1, 5, 4, 2))


@pytest.mark.parametrize("k,cin,cout", [(3, 3, 4), (3, 5, 2), (5, 2, 3)])
def test_s2d_conv_weights_match_jax(k, cin, cout):
    w = np.random.default_rng(1).normal(size=(k, k, cin, cout)).astype(np.float32)
    ours, theirs = _both("s2d_conv_weights", w)
    assert ours.shape == (3, 3, 4 * cin, 4 * cout)
    assert ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("cin,cout", [(3, 4), (6, 5)])
def test_s2d_conv2x2_weights_match_jax(cin, cout):
    w = np.random.default_rng(2).normal(size=(3, 3, cin, cout)).astype(np.float32)
    ours, theirs = _both("s2d_conv2x2_weights", w)
    assert ours.shape == (2, 2, 4 * cin, 4 * cout)
    assert ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize("qx", [0, 1])
def test_s2d_conv2x2_weights_qx_match_jax(qx):
    w = np.random.default_rng(3 + qx).normal(size=(3, 3, 4, 6)).astype(np.float32)
    ours, theirs = _both("s2d_conv2x2_weights_qx", w, qx)
    assert ours.shape == (2, 2, 16, 12)
    assert ours.tobytes() == theirs.tobytes()


def test_s2d_conv2x2_slices_match_jax():
    v = np.random.default_rng(5).normal(size=(2, 7, 5, 4 * 3)).astype(np.float32)
    ours, theirs = _both("s2d_conv2x2_slices", v, 3)
    assert ours.shape == (2, 6, 4, 12)
    assert ours.tobytes() == theirs.tobytes()


def test_s2d_conv2x2_form_is_the_3x3_conv():
    """The parity form through F.conv2d equals the direct SAME conv (the
    identity the K8 kernel and the "2x2" stages rest on)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 12, 10, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 7)).astype(np.float32) * 0.2)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    k = s2d.s2d_conv2x2_weights(w)
    v = F.conv2d(s2d.space_to_depth(x).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    got = s2d.depth_to_space(s2d.s2d_conv2x2_slices(v, 7))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_pack_image_s2d_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 16, 12, 3)).astype(np.float32)
    ours, theirs = pack_image_s2d(x), jax_pack(x)
    assert ours.tobytes() == theirs.tobytes() and ours.shape == (2, 8, 6, 12)
    np.testing.assert_array_equal(ours, s2d.space_to_depth(torch.from_numpy(x)).numpy())
