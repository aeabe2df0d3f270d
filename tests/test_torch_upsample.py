"""The decoders' x2 align-corners upsampling with the deterministic backward
(``pixel_embedded_affinity_torch/ops/upsample_cuda.py``).

The forward is PyTorch's ``F.interpolate`` to the bit. The backward, the
plain version ``My^T g Mx`` that the CPU runs and the card checks against
(the matrices read off the forward on the same device),
equals ``F.interpolate``'s own gradient to 1e-6 of the largest gradient in
float32 (the sums taken in another order) and to 8e-3 in bfloat16 (the
gradient rounded to bfloat16; PyTorch's rounds each partial sum too), at
the decoder shapes of the small test models, odd sizes and a size of 1.
The gather kernel of ``csrc/upsample_bwd.cu`` is compiled with g++ against
``tests/cuda_emu`` (the CUDA runtime on the CPU, each thread a coroutine)
and held to the plain version: float32 at 1e-6, float64 at 1e-12,
bfloat16 at 8e-3. Its speed and its run-to-run bits on the card are
``chip_smoke.py``'s.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pixel_embedded_affinity_torch import cuda_build
from pixel_embedded_affinity_torch.models.common import (upsample_align_corners,
                                                         upsample_xy_align_corners)
from pixel_embedded_affinity_torch.ops.upsample_cuda import (
    SOURCE, UpsampleAlignCorners, forward_matrix, taps, upsample_bwd, upsample_bwd_plain,
    upsample_fwd)
from test_torch_kernel_emulation import EMU, RUNTIME, _emulated_kernel

# the small models' decoder inputs (B=2, filters 8..32 at 64x64 and
# 16..64 3D at 4x32x32) and odd sizes with a size-1 axis
SHAPES_2D = [(2, 32, 8, 8), (2, 16, 16, 16), (2, 8, 32, 32), (1, 3, 5, 7), (1, 2, 1, 9)]
SHAPES_3D = [(2, 64, 4, 4, 4), (2, 32, 4, 8, 8), (2, 16, 4, 16, 16), (1, 3, 3, 5, 1)]
IDS_2D = ["8x8", "16x16", "32x32", "odd", "h1"]
IDS_3D = ["4x4", "8x8", "16x16", "odd-w1"]


def _rand(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _torch_grad(x, g):
    """F.interpolate's own gradient of <up(x), g>."""
    x = x.clone().requires_grad_(True)
    upsample_fwd(x).backward(g)
    return x.grad


@pytest.mark.parametrize("shape", SHAPES_2D + SHAPES_3D, ids=IDS_2D + IDS_3D)
def test_forward_is_f_interpolate_bit_for_bit(shape):
    x = _rand(shape, 0)
    up = upsample_align_corners if len(shape) == 4 else upsample_xy_align_corners
    mode = "bilinear" if len(shape) == 4 else "trilinear"
    scale = 2 if len(shape) == 4 else (1, 2, 2)
    ref = F.interpolate(x, scale_factor=scale, mode=mode, align_corners=True)
    assert torch.equal(up(x), ref)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 8e-3)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES_2D + SHAPES_3D, ids=IDS_2D + IDS_3D)
def test_backward_matches_f_interpolate(shape, dtype, tol):
    x = _rand(shape, 1, dtype)
    out_shape = upsample_fwd(x).shape
    g = _rand(out_shape, 2, dtype)
    ref = _torch_grad(x, g)
    xx = x.clone().requires_grad_(True)
    UpsampleAlignCorners.apply(xx).backward(g)
    assert xx.grad.dtype == dtype and xx.grad.shape == x.shape
    assert _rel(xx.grad, ref) <= tol
    # float64 against float64: the same function
    x64 = x.double().requires_grad_(True)
    UpsampleAlignCorners.apply(x64).backward(g.double())
    assert _rel(x64.grad, _torch_grad(x.double(), g.double())) <= 1e-12


def test_backward_through_a_decoder_matches_f_interpolate():
    """A conv after the upsampling, as in the decoders: the input's gradient
    through the Function against F.interpolate's."""
    x = _rand((2, 8, 12, 10), 3)
    w = _rand((4, 8, 3, 3), 4) * 0.1

    def grad(up):
        xx = x.clone().requires_grad_(True)
        F.conv2d(up(xx), w, padding=1).square().sum().backward()
        return xx.grad

    ref = grad(lambda t: F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True))
    assert _rel(grad(upsample_align_corners), ref) <= 1e-6


def test_plain_backward_refuses_odd_sizes():
    with pytest.raises(ValueError):
        upsample_bwd_plain(torch.zeros(1, 1, 5, 4))


def test_cpu_wrapper_runs_the_plain_version():
    g = _rand((2, 3, 8, 6), 5)
    before = upsample_bwd.launches
    assert torch.equal(upsample_bwd(g), upsample_bwd_plain(g))
    assert upsample_bwd.launches == before


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/upsample_bwd.cu built with g++ against tests/cuda_emu as a
    shared library; its upsample_bwd entry takes host pointers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    out = tmp_path_factory.mktemp("upsample_emu")
    with open(os.path.join(cuda_build.CSRC, SOURCE)) as f:
        text = f.read()
    assert RUNTIME[0] in text and "<<<" in text
    src = out / "upsample_bwd.cpp"
    src.write_text(_emulated_kernel(text.replace(*RUNTIME)))
    so = out / "libupsample_emu.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O2", "-w", "-shared", "-fPIC", "-I", EMU,
                           "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.upsample_bwd.restype = ctypes.c_int
    lib.upsample_bwd.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p] * 3)
    return lib


_EMU_DTYPES = [(torch.float32, 0, 1e-6), (torch.bfloat16, 1, 8e-3), (torch.float64, 2, 1e-12)]


@pytest.mark.parametrize("dtype,code,tol", _EMU_DTYPES, ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("p,h,w", [(3, 8, 8), (2, 5, 37), (1, 1, 9), (2, 13, 1), (4, 9, 40)],
                         ids=["8x8", "ragged", "h1", "w1", "two-blocks"])
def test_kernel_emulated_matches_plain(emulated, p, h, w, dtype, code, tol):
    g = _rand((p, 2 * h, 2 * w), 6, dtype).contiguous()
    out = torch.full((p, h, w), float("nan"), dtype=dtype)
    acc = torch.float64 if code == 2 else torch.float32
    ty, tx = taps(h, -2, 4, "cpu", acc), taps(w, -1, 4, "cpu", acc)
    assert emulated.upsample_bwd(g.data_ptr(), out.data_ptr(), code, p, h, w, ty.data_ptr(),
                                 tx.data_ptr(), None) == 0
    ref = upsample_bwd_plain(g.to(torch.float64 if code == 2 else torch.float32))
    assert _rel(out, ref) <= tol
    # against F.interpolate's own gradient too
    assert _rel(out, _torch_grad(torch.zeros(1, p, h, w, dtype=ref.dtype), g[None].to(ref.dtype))[0]) <= max(tol, 1e-6)


def test_kernel_emulated_refuses_bad_arguments(emulated):
    buf = torch.zeros(16)
    p = buf.data_ptr()
    assert emulated.upsample_bwd(p, p, 3, 1, 2, 2, p, p, None) != 0
    assert emulated.upsample_bwd(p, p, 0, 0, 2, 2, p, p, None) != 0


@pytest.mark.parametrize("n", [1, 2, 5, 34, 136, 272])
@pytest.mark.parametrize("ndim", [4, 5])
def test_forward_matrix_is_the_forward(n, ndim):
    """The matrices read off the forward reproduce it, in each axis, and
    the forward reads no input from beyond 2i +- 2 (the kernel's window)."""
    shape = (2, 3, n, n + 1) if ndim == 4 else (1, 2, 3, n, n + 1)
    x = _rand(shape, 7).double()
    my = forward_matrix(n, -2, ndim, "cpu", torch.float64)
    mx = forward_matrix(n + 1, -1, ndim, "cpu", torch.float64)
    assert my.shape == (2 * n, n) and mx.shape == (2 * n + 2, n + 1)
    assert _rel(my @ x @ mx.t(), upsample_fwd(x)) <= 1e-13
    t = taps(n, -2, ndim, "cpu", torch.float64)
    assert t.shape == (n, 5) and torch.allclose(t.sum(), my.sum())
