"""The int8 kernels of ``csrc/conv_i8.cu`` (I8c, the int8 tensor-core conv,
and I8q, the activation quantizer) compiled with g++ against
``tests/cuda_emu`` as a shared library and held to their plain versions
(``ops/conv_i8_cuda.py``) on the CPU: the kernel's own source, its tiling,
persistent tile walk, TMA ring, mbarriers, wgmma products and epilogue,
with the instructions of ``csrc/wgmma_tma.cuh`` emulated by their PTX ISA
definitions (``hopper_emu.h``: ``wgmma.mma_async m64nNk32 .s8`` from
shared-memory descriptors, read when the warpgroup waits for them;
``cp.async.bulk.tensor`` with the swizzle applied on the write side and
zero fill outside the tensor; ``mbarrier`` phases and transaction
counts) and the driver's tensor maps checked as ``cuTensorMapEncodeTiled``
checks them. Ragged tiles, M tiles across image rows, Cin = 16 and 48 (the
K tails of a 32-byte k-block), k-blocks of 32, 64 and 128 bytes with their
swizzles, N tiles of 64 and 128 against Cout above, equal to and below
them, the narrowed N of a small deep site, a persistent grid walking more
tiles than the emulated card's SMs, Cin = 12 (the wrapper's zero channels),
a 9x9 window, the three paddings of the fast forward, a zero input and
codes at +-127: the int32 accumulators equal exactly, the float32 output
equal to the bit (the epilogue's multiply and add are separate roundings
in both). I8q: .5 ties, saturation, float32 and bfloat16, the 16-byte body
with a head and a tail off the 16-byte boundary, equal to the bit. The
card's timing is ``chip_smoke.py``'s."""

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
    SOURCE, _inv, aligned_operands, conv_i8_acc_plain, conv_i8_plain, conv_plan, pack_weights_i8,
    quantize_act_plain)
from test_torch_kernel_emulation import EMU, RUNTIME, _emulated_kernel

HEADER = "wgmma_tma.cuh"
HEADER_RUNTIME = ("#include <cuda.h>\n#include <cuda_runtime.h>\n", '#include "emu.h"\n')


def _emulated_wgmma_header(text: str) -> str:
    """wgmma_tma.cuh with its asm wrappers replaced by hopper_emu.h (the
    descriptors and the host's tensor-map encoding stay)."""
    start = text.index("__device__ __forceinline__ uint32_t smem_u32")
    end = text.index("// ---- end of the instructions")
    assert HEADER_RUNTIME[0] in text[:start]
    return text[:start].replace(*HEADER_RUNTIME) + '#include "hopper_emu.h"\n' + text[end:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernel")
    out = tmp_path_factory.mktemp("conv_i8_emu")
    with open(os.path.join(cuda_build.CSRC, HEADER)) as f:
        (out / HEADER).write_text(_emulated_wgmma_header(f.read()))
    with open(os.path.join(cuda_build.CSRC, SOURCE)) as f:
        text = f.read()
    assert RUNTIME[0] in text and "<<<" in text
    src = out / "conv_i8.cpp"
    src.write_text(_emulated_kernel(text.replace(*RUNTIME)))
    so = out / "libconv_i8_emu.so"
    # misaligned 16-byte accesses (emu.h's vector types are 16-byte aligned)
    # trap, as they fault on the card
    proc = subprocess.run([gxx, "-std=c++20", "-O2", "-w", "-shared", "-fPIC",
                           "-fsanitize=alignment", "-fsanitize-undefined-trap-on-error",
                           "-I", str(out), "-I", EMU, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.conv_i8_fwd.restype = ctypes.c_int
    lib.conv_i8_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.conv_i8_plan.restype = ctypes.c_int
    lib.conv_i8_plan.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.quantize_i8.restype = ctypes.c_int
    lib.quantize_i8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int64, ctypes.c_void_p]
    return lib


class _Sms:
    """The emulated card's SM count (emu.h's emu_sms), set for a block."""

    def __init__(self, lib, n):
        self.var, self.n = ctypes.c_int.in_dll(lib, "emu_sms"), n

    def __enter__(self):
        self.old, self.var.value = self.var.value, self.n

    def __exit__(self, *exc):
        self.var.value = self.old


def _conv(lib, x, w, scale, shift, padding):
    """The emulated kernel through the wrapper's own operand preparation."""
    b, h, wd, _ = x.shape
    pt, pb, pl, pr = padding
    ho, wo = h + pt + pb - w.kh + 1, wd + pl + pr - w.kw + 1
    xa, packed = aligned_operands(x, w)
    out = torch.full((b, ho, wo, w.cout), float("nan"))
    if scale is None:
        out = out.view(torch.int32)
    err = lib.conv_i8_fwd(xa.data_ptr(), packed.data_ptr(),
                          None if scale is None else scale.data_ptr(),
                          None if shift is None else shift.data_ptr(), out.data_ptr(),
                          b, h, wd, xa.shape[-1], w.cout, w.kh, w.kw, pt, pb, pl, pr, None)
    assert err == 0
    return out


PAD = {"same": (1, 1, 1, 1), "qx0": (1, 1, 1, 0), "qx1": (1, 1, 0, 1), "nine": (4, 4, 4, 4)}
CASES = [
    # b, h, w, cin, cout, k, padding, emulated SMs, expected plan (S, BN, BM), what
    (1, 10, 20, 32, 64, 3, "same", 3, (32, 64, 128), "ragged tiles, N = Cout = 64"),
    (2, 9, 17, 16, 24, 3, "same", 3, (32, 64, 128), "Cin 16: half a k-block, Cout < N"),
    (1, 8, 16, 48, 40, 3, "same", 3, (32, 64, 128), "Cin 48: a ragged last k-block"),
    (1, 12, 18, 64, 80, 3, "same", 3, (64, 128, 128), "64-byte k-blocks, Cout 80 < N = 128"),
    (1, 9, 10, 12, 16, 3, "same", 3, (32, 64, 128), "Cin 12: the wrapper's zero channels"),
    (2, 7, 9, 32, 32, 2, "qx0", 3, (32, 64, 128), "2x2 parity conv, x parity 0"),
    (1, 11, 13, 48, 24, 2, "qx1", 3, (32, 64, 128), "2x2 parity conv, x parity 1, K tail"),
    (1, 21, 37, 32, 64, 3, "same", 3, (32, 64, 128),
     "M tiles across image rows, ragged in x and y, 9 tiles on 3 SMs"),
    (1, 9, 12, 128, 128, 3, "same", 3, (128, 128, 128), "128-byte k-blocks, N = Cout = 128"),
    (1, 6, 10, 256, 48, 3, "same", 3, (128, 64, 128), "two 128-byte k-blocks a tap"),
    (1, 8, 8, 64, 256, 3, "same", 3, (64, 128, 128), "N = 128 below Cout = 256"),
    (1, 40, 40, 16, 64, 3, "same", 3, (32, 64, 256), "M tiles of 256 pixels, 9 tiles on 3 SMs"),
    (2, 13, 40, 32, 56, 3, "qx1", 3, (32, 64, 256),
     "M tiles of 256 pixels, N = 64, ragged, two images"),
    (1, 34, 34, 16, 512, 3, "same", 132, (32, 64, 128),
     "34x34, Cout 512 on 132 SMs: N narrowed to 64, 120 tiles"),
    (1, 9, 9, 16, 16, 9, "nine", 3, (32, 64, 128), "a 9x9 window"),
]


@pytest.mark.parametrize("b,h,w,cin,cout,k,pad,sms,plan,what", CASES, ids=[c[-1] for c in CASES])
def test_conv_i8_kernel_emulated(emulated, b, h, w, cin, cout, k, pad, sms, plan, what):
    rng = np.random.default_rng(cin * 131 + cout + h)
    x = torch.from_numpy(rng.integers(-127, 128, size=(b, h, w, cin)).astype(np.int8))
    x[0, 0, :2] = 127                                  # saturated codes
    x[-1, -1, -1] = -127
    wq = pack_weights_i8(torch.from_numpy(
        rng.integers(-127, 128, size=(k, k, cin, cout)).astype(np.int8)))
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-2, cout).astype(np.float32))
    shift = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    with _Sms(emulated, sms):
        got_plan = conv_plan(x.shape, wq, PAD[pad], lib=emulated)
        assert (got_plan["S"], got_plan["BN"], got_plan["BM"]) == plan
        assert got_plan["grid"] == min(got_plan["tiles"], sms)
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
    # Cin not a multiple of 16 (TMA's 16-byte strides; the wrapper pads it)
    assert emulated.conv_i8_fwd(p, p, f, None, f, 1, 9, 9, 4, 4, 9, 9, 4, 4, 4, 4, None) != 0
    # an input off the 16-byte alignment TMA needs
    assert emulated.conv_i8_fwd(p + 1, p, f, None, f, 1, 1, 1, 16, 4, 1, 1, 0, 0, 0, 0,
                                None) != 0


def test_conv_i8_aligned_operands():
    """The wrapper's operands: an aligned Cin % 16 == 0 input is passed as it
    is; Cin 12 gets 4 zero channels in a copy, the weights 4 zero columns a
    tap, and the plain conv of the padded pair equals the original's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, size=(1, 5, 6, 12)).astype(np.int8))
    w = pack_weights_i8(torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 12, 8))
                                         .astype(np.int8)))
    xa, pa = aligned_operands(x, w)
    assert xa.shape == (1, 5, 6, 16) and pa.shape == (8, 9 * 16)
    assert not xa[..., 12:].any() and torch.equal(xa[..., :12], x)
    wa = w._replace(packed=pa)
    assert torch.equal(conv_i8_acc_plain(xa, wa), conv_i8_acc_plain(x, w))
    x16 = torch.from_numpy(rng.integers(-127, 128, size=(1, 5, 6, 16)).astype(np.int8))
    w16 = pack_weights_i8(torch.zeros(3, 3, 16, 8, dtype=torch.int8))
    got = aligned_operands(x16, w16)
    assert got[0] is x16 and got[1] is w16.packed


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [0.5, 2.0 / 127.0, 0.013])
@pytest.mark.parametrize("offset", [0, 3], ids=["aligned", "head3"])
def test_quantize_kernel_emulated(emulated, dtype, code, scale, offset):
    """offset 3: input and output start 3 elements past a 16-byte boundary,
    so the kernel's scalar head takes 13 elements before its 16-byte body;
    1606 - 3 elements leave a scalar tail of 3 (11 aligned)."""
    rng = np.random.default_rng(8)
    x = np.concatenate([np.arange(-300, 300, dtype=np.float32) * 0.5 + 0.25,
                        [0.0, -0.0, 99.0, -99.0, 1e30, -1e30],
                        rng.normal(scale=2.0, size=1000).astype(np.float32)])
    t = torch.from_numpy(x).to(dtype, copy=True)[offset:]
    buf = torch.full((x.size,), 55, dtype=torch.int8)
    out = buf[offset:]
    assert emulated.quantize_i8(t.data_ptr(), out.data_ptr(), code, _inv(scale), t.numel(),
                                None) == 0
    assert torch.equal(out, quantize_act_plain(t, scale))
    assert torch.equal(buf[:offset], torch.full((offset,), 55, dtype=torch.int8))
    assert int(out.max()) == 127 and int(out.min()) == -127
