"""The deterministic conv backward of the 2D models (``csrc/conv_grad.cu``,
``ops/conv_grad_cuda.py``, ``models/common.py``'s
``Conv2dDeterministicGrad``) on the CPU.

* The Function's CPU backward goes through the wrappers' plain versions:
  dx and dW bit for bit ``aten.convolution_backward``, the backward that
  autograd runs for ``F.conv2d``, and db the sum of dy over N, H, W, as on
  the card; with and without a bias and an input gradient.
* The ResNets' other float32 convs (strided, 7x7) take
  ``Conv2dCudnnDeterministicGrad``, whose backward is
  ``aten.convolution_backward`` (under cuDNN's deterministic algorithms on
  the card): bit for bit on the CPU.
* Its gradients match JAX's VJP of a ``lax.conv_general_dilated`` conv
  (``highest`` precision, tests/conftest.py) at 1e-5 of the largest
  gradient, 1x1 and 3x3, Cin in {1, 3, 16, 96}.
* The wrappers on CPU tensors run their plain versions, within 1e-6 of a
  float64 run.
* The kernels' own source, compiled with g++ through ``tests/cuda_emu``
  (``conv_grad_harness.cpp``: each CUDA thread a coroutine, mma.sync,
  cvt.rna.tf32 and cp.async by the PTX ISA), against a float64 reference at
  the card's 1e-5 gate: ragged channel tiles, a pixel tail in an image's
  last 128-pixel chunk, widths that are and are not a multiple of 4 (16-
  and 4-byte copies), several split counts for CWg; and two runs, the
  second with the grid's blocks in reverse order, bit-equal.

``tests/test_torch_conv_grad_cuda.py`` checks the kernels on a card.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import torch.nn.functional as F

from pixel_embedded_affinity_torch import cuda_build
from pixel_embedded_affinity_torch.models.common import (
    Conv2d, Conv2dCudnnDeterministicGrad, Conv2dDeterministicGrad)
from pixel_embedded_affinity_torch.ops.conv_grad_cuda import (
    conv_dgrad, conv_dgrad_plain, conv_wgrad, conv_wgrad_plain)

from test_torch_kernel_emulation import EMU, RUNTIME, _emulated_header, _emulated_kernel

GATE = 1e-5  # the card's float32 gate, of the largest gradient


def _case(seed, b, cin, cout, h, w, k, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, cin, h, w)).astype(dtype)
    wt = (rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(dtype)
    bias = rng.normal(size=(cout,)).astype(dtype)
    dy = rng.normal(size=(b, cout, h, w)).astype(dtype)
    return x, wt, bias, dy


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _grads(fn, x, wt, bias, dy, need_x=True):
    tx = torch.from_numpy(x).requires_grad_(need_x)
    tw = torch.from_numpy(wt).requires_grad_()
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    fn(tx, tw, tb).backward(torch.from_numpy(dy))
    return [None if t is None or t.grad is None else t.grad for t in (tx, tw, tb)]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bias,need_x", [(True, True), (False, True), (True, False)],
                         ids=["bias", "no_bias", "image"])
def test_function_cpu_backward_is_convolution_backward(k, bias, need_x):
    x, wt, b, dy = _case(1, 2, 5, 7, 9, 11, k)
    b = b if bias else None
    got = _grads(Conv2dDeterministicGrad.apply, x, wt, b, dy, need_x)
    ref = torch.ops.aten.convolution_backward(
        torch.from_numpy(dy), torch.from_numpy(x), torch.from_numpy(wt),
        [wt.shape[0]] if bias else None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1,
        [need_x, True, bias])
    native = _grads(lambda a, w_, b_: F.conv2d(a, w_, b_, 1, k // 2), x, wt, b, dy, need_x)
    for g, r, n in zip(got, ref, native):
        assert (g is None) == (r is None) == (n is None)
    for g, r, n in zip(got[:2], ref[:2], native[:2]):
        if g is not None:
            assert torch.equal(g, r) and torch.equal(g, n)
    if bias:  # aten's db sums in another order: within float32 rounding of it
        assert torch.equal(got[2], torch.from_numpy(dy).sum((0, 2, 3)))
        assert _rel(got[2], ref[2]) <= 1e-6


@pytest.mark.parametrize("k,stride", [(3, 2), (7, 2), (1, 2), (3, 1)])
@pytest.mark.parametrize("bias,need_x", [(True, True), (False, True), (False, False)],
                         ids=["bias", "no_bias", "image"])
def test_cudnn_function_cpu_backward_is_convolution_backward(k, stride, bias, need_x):
    x, wt, b, dy = _case(2, 2, 6, 8, 15, 13, k)
    b = b if bias else None
    geometry = ((stride, stride), (k // 2, k // 2), (1, 1), 1)
    y = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt), None, *geometry)
    dy = np.random.default_rng(3).normal(size=tuple(y.shape)).astype(np.float32)
    got = _grads(lambda a, w_, b_: Conv2dCudnnDeterministicGrad.apply(a, w_, b_, geometry),
                 x, wt, b, dy, need_x)
    native = _grads(lambda a, w_, b_: F.conv2d(a, w_, b_, *geometry), x, wt, b, dy, need_x)
    for g, n in zip(got, native):
        assert (g is None) == (n is None)
        if g is not None:
            assert torch.equal(g, n)


def _jax_conv(x, w, b, k):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), [(k // 2, k // 2)] * 2,
                                     dimension_numbers=("NCHW", "OIHW", "NCHW"))
    return y + b[None, :, None, None]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cin", [1, 3, 16, 96])
def test_function_matches_jax_vjp(k, cin):
    x, wt, b, dy = _case(cin + k, 2, cin, 24, 13, 17, k)
    got = _grads(Conv2dDeterministicGrad.apply, x, wt, b, dy)
    y, vjp = jax.vjp(lambda a, w_, b_: _jax_conv(a, w_, b_, k), *map(jnp.asarray, (x, wt, b)))
    np.testing.assert_allclose(np.asarray(y), F.conv2d(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), 1, k // 2).numpy(),
        atol=1e-5)
    for g, r in zip(got, vjp(jnp.asarray(dy))):
        assert _rel(g.numpy(), r) <= GATE


def test_conv2d_takes_the_function_only_for_float32_on_the_card():
    """On the CPU the module runs nn.Conv2d's own forward (so the CPU tests
    against JAX see no change); the Function is for stride-1 SAME 1x1 and
    3x3 convs only."""
    assert Conv2d(4, 8, 3, padding=1)._kernel_grad
    assert Conv2d(4, 8, 1)._kernel_grad
    assert not Conv2d(4, 8, 3, stride=2, padding=1)._kernel_grad
    assert not Conv2d(4, 8, 7, padding=3)._kernel_grad
    assert not Conv2d(4, 8, 3)._kernel_grad  # VALID
    conv = Conv2d(4, 8, 3, padding=1)
    y = conv(torch.randn(1, 4, 6, 6, requires_grad=True))
    assert "Conv2dDeterministicGrad" not in type(y.grad_fn).__name__


@pytest.mark.parametrize("k", [1, 3])
def test_wrappers_run_their_plain_versions_on_the_cpu(k):
    x, wt, _, dy = _case(5, 2, 12, 20, 10, 14, k)
    tx, tw, tdy = map(torch.from_numpy, (x, wt, dy))
    dw, dx = conv_wgrad(tx, tdy, wt.shape), conv_dgrad(tdy, tw)
    assert torch.equal(dw, conv_wgrad_plain(tx, tdy, wt.shape))
    assert torch.equal(dx, conv_dgrad_plain(tdy, tw))
    dw64 = conv_wgrad_plain(tx.double(), tdy.double(), wt.shape)
    dx64 = conv_dgrad_plain(tdy.double(), tw.double())
    assert dw64.dtype == dx64.dtype == torch.float64
    assert _rel(dw, dw64) <= 1e-6 and _rel(dx, dx64) <= 1e-6
    with pytest.raises(ValueError):
        conv_wgrad(tx, tdy, (20, 12, 5, 5))
    with pytest.raises(ValueError):
        conv_dgrad(tdy[:, :3], tw)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("conv_grad_emu")
    with open(os.path.join(cuda_build.CSRC, "mma_tc.cuh")) as f:
        (out / "mma_tc.cuh").write_text(_emulated_header(f.read()).replace(*RUNTIME))
    with open(os.path.join(cuda_build.CSRC, "conv_grad.cu")) as f:
        text = f.read()
    assert RUNTIME[0] in text
    (out / "conv_grad.cpp").write_text(_emulated_kernel(text.replace(*RUNTIME)))
    exe = out / "harness"
    cmd = [gxx, "-std=c++20", "-O2", "-w", "-I", str(out), "-I", EMU, "-o", str(exe),
           str(out / "conv_grad.cpp"), os.path.join(EMU, "conv_grad_harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(exe)


def _run(exe, *args):
    proc = subprocess.run([exe, *map(str, args)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"rel_err (\S+) bit_equal (\d) splits (\d+)", proc.stdout)
    return float(m.group(1)), m.group(2) == "1", int(m.group(3))


@pytest.mark.parametrize("b,cin,cout,h,w,k,splits", [
    (2, 3, 16, 9, 20, 3, 1),     # the RGB input conv: 3 of 8 channels live; a pixel tail
    (2, 3, 16, 9, 20, 3, 3),     # ... three splits of the 4 chunks
    (2, 1, 16, 16, 16, 3, 0),    # the BBBC input conv, the kernel's own split count
    (2, 16, 40, 11, 13, 3, 0),   # W % 4 != 0 (4-byte copies); 40 = 32 + 8 output channels
    (1, 12, 32, 8, 24, 3, 2),    # 12 = 8 + 4 input channels
    (2, 40, 2, 10, 28, 1, 5),    # a 1x1 head: 2 of 16 rows live, 40 = 32 + 8 channels
    (1, 96, 16, 12, 12, 1, 0),   # 1x1, three channel tiles
])
def test_wgrad_kernel_emulated(harness, b, cin, cout, h, w, k, splits):
    err, same, used = _run(harness, "wgrad", b, cin, cout, h, w, k, splits)
    assert err <= GATE and same
    assert used == splits or splits == 0


@pytest.mark.parametrize("b,cin,cout,h,w,k", [
    (2, 16, 16, 9, 20, 3),       # 16 input channels a block; a pixel tail
    (2, 32, 37, 11, 13, 3),      # W % 4 != 0; 37 = 4 x 8 + 5 output channels
    (1, 96, 32, 8, 24, 3),       # 96 = 64 + 32 input channels
    (2, 64, 16, 10, 28, 1),      # 1x1: one K chunk of 32, 16 live
    (2, 20, 70, 7, 9, 1),        # 1x1: H W = 63, 70 = 2 x 32 + 6 output channels
])
def test_dgrad_kernel_emulated(harness, b, cin, cout, h, w, k):
    err, same, _ = _run(harness, "dgrad", b, cin, cout, h, w, k)
    assert err <= GATE and same
