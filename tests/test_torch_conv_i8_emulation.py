"""The int8 kernels of ``csrc/conv_i8.cu`` (I8c, the int8 tensor-core conv,
and I8q, the activation quantizer) compiled with g++ against
``tests/cuda_emu`` as a shared library and held to their plain versions
(``ops/conv_i8_cuda.py``) on the CPU: the kernel's own source, its
tiling, cp.async staging with zero fill, ring, ldmatrix fragment loads and
epilogue, with the instructions of ``csrc/mma_tc.cuh`` emulated by the PTX
ISA's fragment layouts (``mma_emu.h``: ``mma.sync m16n8k32 s8``). Ragged
tiles, Cin = 16 and 48 (the K tails of a 32-channel chunk), Cin = 12 (the
byte-load path), two output-channel blocks, the three paddings of the fast
forward, a zero input and codes at +-127: the int32 accumulators equal
exactly, the float32 output equal to the bit (the epilogue's multiply and
add are separate roundings in both). I8q: .5 ties, saturation, float32 and
bfloat16, equal to the bit. The card's timing is ``chip_smoke.py``'s."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_torch import cuda_build
from pixel_embedded_affinity_torch.ops.conv_i8_cuda import (
    SOURCE, _inv, conv_i8_acc_plain, conv_i8_plain, pack_weights_i8, quantize_act_plain)
from test_torch_kernel_emulation import EMU, RUNTIME, _emulated_header, _emulated_kernel


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    out = tmp_path_factory.mktemp("conv_i8_emu")
    with open(os.path.join(cuda_build.CSRC, "mma_tc.cuh")) as f:
        (out / "mma_tc.cuh").write_text(_emulated_header(f.read()).replace(*RUNTIME))
    with open(os.path.join(cuda_build.CSRC, SOURCE)) as f:
        text = f.read()
    assert RUNTIME[0] in text and "<<<" in text
    src = out / "conv_i8.cpp"
    src.write_text(_emulated_kernel(text.replace(*RUNTIME)))
    so = out / "libconv_i8_emu.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O2", "-w", "-shared", "-fPIC", "-I", str(out),
                           "-I", EMU, "-o", str(so), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.conv_i8_fwd.restype = ctypes.c_int
    lib.conv_i8_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.quantize_i8.restype = ctypes.c_int
    lib.quantize_i8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int64, ctypes.c_void_p]
    return lib


def _conv(lib, x, w, scale, shift, padding):
    b, h, wd, cin = x.shape
    pt, pb, pl, pr = padding
    ho, wo = h + pt + pb - w.kh + 1, wd + pl + pr - w.kw + 1
    out = torch.full((b, ho, wo, w.cout), float("nan"))
    if scale is None:
        out = out.view(torch.int32)
    err = lib.conv_i8_fwd(x.data_ptr(), w.packed.data_ptr(),
                          None if scale is None else scale.data_ptr(),
                          None if shift is None else shift.data_ptr(), out.data_ptr(),
                          b, h, wd, cin, w.cout, w.kh, w.kw, pt, pb, pl, pr, None)
    assert err == 0
    return out


PAD = {"same": (1, 1, 1, 1), "qx0": (1, 1, 1, 0), "qx1": (1, 1, 0, 1)}
CASES = [
    # b, h, w, cin, cout, k, padding, what
    (1, 10, 20, 32, 64, 3, "same", "ragged tiles"),
    (2, 9, 17, 16, 24, 3, "same", "Cin 16: half a chunk, Cout < a block"),
    (1, 8, 16, 48, 40, 3, "same", "Cin 48: a ragged last chunk"),
    (1, 12, 18, 64, 80, 3, "same", "two output-channel blocks, two chunks"),
    (1, 9, 10, 12, 16, 3, "same", "Cin 12: byte loads"),
    (2, 7, 9, 32, 32, 2, "qx0", "2x2 parity conv, x parity 0"),
    (1, 11, 13, 48, 24, 2, "qx1", "2x2 parity conv, x parity 1, K tail"),
]


@pytest.mark.parametrize("b,h,w,cin,cout,k,pad,what", CASES, ids=[c[-1] for c in CASES])
def test_conv_i8_kernel_emulated(emulated, b, h, w, cin, cout, k, pad, what):
    rng = np.random.default_rng(cin * 131 + cout)
    x = torch.from_numpy(rng.integers(-127, 128, size=(b, h, w, cin)).astype(np.int8))
    x[0, 0, :2] = 127                                  # saturated codes
    x[-1, -1, -1] = -127
    wq = pack_weights_i8(torch.from_numpy(
        rng.integers(-127, 128, size=(k, k, cin, cout)).astype(np.int8)))
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-2, cout).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    acc = _conv(emulated, x, wq, None, None, PAD[pad])
    assert torch.equal(acc, conv_i8_acc_plain(x, wq, PAD[pad]))
    for sh in (None, shift):
        got = _conv(emulated, x, wq, scale, sh, PAD[pad])
        assert torch.equal(got, conv_i8_plain(x, wq, scale, sh, PAD[pad]))


def test_conv_i8_kernel_emulated_zero_input(emulated):
    x = torch.zeros(1, 6, 18, 32, dtype=torch.int8)
    wq = pack_weights_i8(torch.full((3, 3, 32, 16), -127, dtype=torch.int8))
    shift = torch.linspace(-1, 1, 16)
    got = _conv(emulated, x, wq, torch.ones(16), shift, PAD["same"])
    assert torch.equal(got, shift.expand_as(got))
    assert torch.equal(_conv(emulated, x, wq, None, None, PAD["same"]),
                       torch.zeros(got.shape, dtype=torch.int32))


def test_conv_i8_kernel_emulated_largest_accumulator(emulated):
    """Every code at +-127: |acc| = 127^2 x 9 x 96 at the centre, past
    float32's 2^24, so the float32 conversion rounds, the same in both."""
    x = torch.full((1, 5, 17, 96), 127, dtype=torch.int8)
    wq = pack_weights_i8(torch.full((3, 3, 96, 8), -127, dtype=torch.int8))
    acc = _conv(emulated, x, wq, None, None, PAD["same"])
    assert int(acc.min()) == -127 * 127 * 9 * 96
    assert torch.equal(acc, conv_i8_acc_plain(x, wq))
    scale = torch.full((8,), 1e-3)
    assert torch.equal(_conv(emulated, x, wq, scale, None, PAD["same"]),
                       conv_i8_plain(x, wq, scale))


def test_conv_i8_kernel_emulated_refuses_bad_shapes(emulated):
    p = torch.zeros(64, dtype=torch.int8).data_ptr()
    f = torch.zeros(64).data_ptr()
    assert emulated.conv_i8_fwd(p, p, f, None, f, 1, 2, 2, 4, 4, 5, 5, 0, 0, 0, 0, None) != 0
    assert emulated.conv_i8_fwd(p, p, f, None, f, 1, 4, 4, 4, 4, 3, 3, -1, 1, 1, 1, None) != 0
    # a 9x9 window's three stages exceed a block's shared memory
    assert emulated.conv_i8_fwd(p, p, f, None, f, 1, 9, 9, 4, 4, 9, 9, 4, 4, 4, 4, None) != 0


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [0.5, 2.0 / 127.0, 0.013])
def test_quantize_kernel_emulated(emulated, dtype, code, scale):
    rng = np.random.default_rng(8)
    x = np.concatenate([np.arange(-300, 300, dtype=np.float32) * 0.5 + 0.25,
                        [0.0, -0.0, 99.0, -99.0, 1e30, -1e30],
                        rng.normal(scale=2.0, size=1000).astype(np.float32)])
    t = torch.from_numpy(x.astype(np.float32)).to(dtype)
    out = torch.full(t.shape, 55, dtype=torch.int8)
    assert emulated.quantize_i8(t.data_ptr(), out.data_ptr(), code, _inv(scale), t.numel(),
                                None) == 0
    assert torch.equal(out, quantize_act_plain(t, scale))
    assert int(out.max()) == 127 and int(out.min()) == -127
