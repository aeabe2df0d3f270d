"""The port's tensor-core kernels, ``csrc/conv3x3.cu`` (K7/K9a/K9b) and
``csrc/s2d_block.cu`` (K8), compiled with g++ and run on the CPU against a
float64 reference: ``tests/cuda_emu`` stands in for the CUDA runtime (each
CUDA thread a coroutine, barriers released by a scheduler) and for the
instructions that ``csrc/mma_tc.cuh`` wraps (cp.async, cvt.rna.tf32,
mma.sync and ldmatrix, by the PTX ISA's fragment layouts). The kernels'
own source is used unchanged apart from its asm wrappers, so their tiling,
staging, pipelines, s2d address map, ring and epilogues are checked here;
the card's timing and the hardware's own rounding are not (chip_smoke.py
holds the kernels against their plain versions on the card). Small shapes,
ragged tiles, Cin = 3 (the plain-load path), split K8 inputs and the canvas
mode's exact zeros; float32 at the card's 1e-5 gate, bf16 at 8e-3."""

import os
import re
import shutil
import subprocess

import pytest

from pixel_embedded_affinity_torch import cuda_build

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu")
RUNTIME = ("#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n", '#include "emu.h"\n')


def _emulated_header(text: str) -> str:
    """mma_tc.cuh with its asm wrappers replaced by mma_emu.h (split_tf32,
    built on them, stays)."""
    start = text.index("__device__ __forceinline__ uint32_t smem_addr")
    split = text.index("// x = hi + lo")
    mma = text.index("__device__ __forceinline__ void mma_tf32")
    end = text.index("__device__ __forceinline__ float to_float(float v)")
    assert start < split < mma < end
    return text[:start] + '#include "mma_emu.h"\n' + text[split:mma] + text[end:]


def _emulated_kernel(text: str) -> str:
    text = text.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                        "using ::smem_raw;")
    return re.sub(r"(\w+<[^<>]*>)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });",
                  text, flags=re.S)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    with open(os.path.join(cuda_build.CSRC, "mma_tc.cuh")) as f:
        (out / "mma_tc.cuh").write_text(_emulated_header(f.read()).replace(*RUNTIME))
    objs = []
    for name in ("conv3x3", "s2d_block"):
        with open(os.path.join(cuda_build.CSRC, f"{name}.cu")) as f:
            text = f.read()
        assert RUNTIME[0] in text and "<<<" in text
        (out / f"{name}.cpp").write_text(_emulated_kernel(text.replace(*RUNTIME)))
        objs.append(out / f"{name}.cpp")
    exe = out / "harness"
    cmd = [gxx, "-std=c++20", "-O2", "-w", "-I", str(out), "-I", EMU, "-o", str(exe),
           *map(str, objs), os.path.join(EMU, "harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(exe)


def _run(exe, *args):
    proc = subprocess.run([exe, *map(str, args)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"rel_err (\S+) zeros_outside (\d)", proc.stdout)
    return float(m.group(1)), m.group(2) == "1"


_TOL = {0: 1e-5, 1: 8e-3}


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,cin,cout,off,relu", [
    (1, 10, 20, 16, 64, 1, 0),   # ragged tiles
    (2, 9, 17, 3, 16, 1, 1),     # Cin = 3: plain loads, K padded in shared memory
    (1, 8, 16, 40, 40, 1, 1),    # Cout < one block, a ragged last chunk
    (1, 12, 18, 24, 80, 1, 0),   # two output-channel blocks
    (1, 11, 13, 16, 16, 0, 1),   # canvas mode
    (1, 5, 7, 5, 7, 1, 1),       # odd channels both ways
])
def test_conv3x3_kernel_emulated(harness, b, h, w, cin, cout, off, relu, dtype):
    err, zeros = _run(harness, "conv", b, h, w, cin, cout, off, relu, dtype)
    assert err <= _TOL[dtype]
    assert zeros


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,parts", [
    (1, 5, 6, 16, (3,)),         # the input block: plain loads
    (2, 5, 7, 16, (8, 8)),       # a split block, B = 2
    (1, 9, 10, 32, (24,)),       # ragged chunks and tiles
    (1, 8, 9, 64, (16, 32)),     # c = 64, three stages
])
def test_s2d_block_kernel_emulated(harness, b, h, w, c, parts, dtype):
    err, _ = _run(harness, "k8", b, h, w, c, dtype, *parts)
    assert err <= _TOL[dtype]
