"""The port's tensor-core kernels, ``csrc/conv3x3.cu`` (K7/K9a/K9b) and
``csrc/s2d_block.cu`` (K8), and its affinity kernels, ``csrc/affinity2d.cu``
(K1f), ``csrc/affinity3d.cu`` (K5f), ``csrc/affinity_grad.cu`` (K5b, K1b at
D = 1, the cross kernels) and ``csrc/affinity_wmse2d.cu`` (the loss-fused
K2f/K2b, K3f/K3b), which
gather each neighbour through the cache, one thread a voxel or pixel,
compiled with g++ and run on the CPU against a float64 reference:
``tests/cuda_emu`` stands in for the CUDA runtime (each CUDA thread a
coroutine, barriers and warp shuffles released by a scheduler) and for
the instructions that ``csrc/mma_tc.cuh`` wraps (cp.async, cvt.rna.tf32,
mma.sync and ldmatrix, by the PTX ISA's fragment layouts). The kernels'
own source is used unchanged apart from its asm wrappers, so their
tiling, staging, pipelines, s2d address map, ring and epilogues are
checked here; the card's timing and the hardware's own rounding are not
(chip_smoke.py holds the kernels against their plain versions on the
card). Small shapes, ragged tiles, Cin = 3 (the plain-load path), split
K8 inputs and the canvas mode's exact zeros; float32 at the card's 1e-5
gate, bf16 at 8e-3. The affinity kernels: ragged tiles, D < 4 and H, W <
27 (whole channels outside), a zero vector, C = 8, the permuted NCDHW
view, other shift and offset tables (negative, zero, diagonal, far z),
neighbor 4 and 8 at D = 1, the raw form, bf16; K1f at the card's 1e-5
gate (64 random offsets too), K5f at its 1e-6, both with their exact zeros, the backward at 1e-5 of the largest gradient
(and at the zero vector's voxel, of its own). The staged z-walk forms of
the two affinity kernels (``tools/affinity_zwalk.cu``) run the same cases
in ``test_torch_kernel_emulation_zwalk.py``. The WMSE kernels (C = 16), float32 and
bfloat16: the self and cross forms, K3b without db (the training step's
call) and with it, ragged tiles, H, W < 27, a zero vector, K = 1,
neighbor 4's 10 offsets and neighbor 8's diagonals, a teacher with H
stride 1, channels-last embeddings and a non-binary mask; the affinities
at 1e-5 (bfloat16: 8e-3, their rounding) with their exact zeros, the sums
S at 1e-5 relative in both dtypes (the block partials summed in float32,
as the wrapper sums them, and in float64; bfloat16 or not, S is taken in
float32 from the unrounded affinities of the same inputs), the gradients
as the affinity backward's (bfloat16: 8e-3)."""

import os
import re
import shutil
import subprocess

import numpy as np
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
    return re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });",
                  text, flags=re.S)


ZWALK = os.path.join(os.path.dirname(EMU), os.pardir, "tools", "affinity_zwalk.cu")


def _build(out, affinity_sources):
    """The harness with the conv and s2d kernels and the given sources of
    affinity3d_fwd and affinity_bwd, built in ``out``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    with open(os.path.join(cuda_build.CSRC, "mma_tc.cuh")) as f:
        (out / "mma_tc.cuh").write_text(_emulated_header(f.read()).replace(*RUNTIME))
    with open(os.path.join(cuda_build.CSRC, "affinity_load.cuh")) as f:
        (out / "affinity_load.cuh").write_text(f.read().replace(*RUNTIME))
    objs = []
    base = [os.path.join(cuda_build.CSRC, f"{n}.cu") for n in ("conv3x3", "s2d_block")]
    for path in base + affinity_sources:
        with open(path) as f:
            text = f.read()
        assert RUNTIME[0] in text and "<<<" in text
        name = os.path.splitext(os.path.basename(path))[0]
        (out / f"{name}.cpp").write_text(_emulated_kernel(text.replace(*RUNTIME)))
        objs.append(out / f"{name}.cpp")
    exe = out / "harness"
    cmd = [gxx, "-std=c++20", "-O2", "-w", "-I", str(out), "-I", EMU, "-o", str(exe),
           *map(str, objs), os.path.join(EMU, "harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(exe)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("cuda_emu"),
                  [os.path.join(cuda_build.CSRC, f"{n}.cu")
                   for n in ("affinity2d", "affinity3d", "affinity_grad", "affinity_wmse2d")])


def _run(exe, *args):
    proc = subprocess.run([exe, *map(str, args)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"(?:rel|abs)_err (\S+) zeros_outside (\d)", proc.stdout)
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


# a shift table with a zero, negative shifts (halo below and to the right),
# a far z and a far y shift
_ODD_SHIFTS = (2, 0, 5, 5, -2, 1, 1, 12, -3)


_K5F_CASES = [
    (2, 6, 21, 35, 16, 1, ()),   # ragged tiles, the NCDHW view
    (2, 3, 20, 25, 16, 0, ()),   # D < 4, H, W < 27
    (1, 5, 17, 19, 8, 0, ()),    # C = 8
    (1, 7, 18, 20, 16, 1, _ODD_SHIFTS),
]
_K5F_IDS = ["view", "small", "c8", "odd-shifts"]


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,layout,shifts", _K5F_CASES, ids=_K5F_IDS)
def test_affinity3d_kernel_emulated(harness, b, d, h, w, c, layout, shifts, dtype):
    err, zeros = _run(harness, "k5f", b, d, h, w, c, dtype, layout, *shifts)
    assert err <= {0: 1e-6, 1: 8e-3}[dtype]
    assert zeros


def _offsets_2d(neighbor):
    from pixel_embedded_affinity_torch.ops import multi_offset

    return [v for dy, dx in multi_offset([1, 3, 5, 9, 27], neighbor) for v in (0, dy, dx)]


# (dz, dy, dx): z offsets of either sign, an in-slice diagonal, far z,
# far y and a far diagonal
_ODD_OFFSETS = (1, 0, 0, -3, 0, 0, 0, 2, -1, 0, 0, 4, 5, 0, 0, 0, -12, 0, 1, 1, 1)


_BWD_CASES = [
    (2, 6, 21, 35, 16, 1, 0, ()),    # the 3D table: ragged tiles, the NCDHW view
    (2, 3, 20, 25, 16, 0, 0, ()),    # D < 4, H, W < 27
    (1, 5, 17, 19, 8, 0, 0, ()),     # C = 8
    (1, 5, 17, 19, 16, 1, 1, ()),    # raw
    (1, 7, 18, 20, 16, 0, 0, _ODD_OFFSETS),
    (2, 1, 37, 29, 16, 1, 0, "n4"),  # D = 1: K1's offsets
    (2, 1, 37, 29, 16, 1, 0, "n8"),  # neighbor 8's diagonals
]
_BWD_IDS = ["view", "small", "c8", "raw", "odd", "2d-n4", "2d-n8"]


def _bwd(exe, b, d, h, w, c, layout, raw, offsets, dtype):
    err, _ = _run(exe, "bwd", b, d, h, w, c, dtype, layout, raw, *_table(offsets))
    assert err <= {0: 1e-5, 1: 8e-3}[dtype]


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,layout,raw,offsets", _BWD_CASES, ids=_BWD_IDS)
def test_affinity_bwd_kernel_emulated(harness, b, d, h, w, c, layout, raw, offsets, dtype):
    _bwd(harness, b, d, h, w, c, layout, raw, offsets, dtype)


# layouts of the cross kernels' two inputs (the harness's numbering)
CL, VIEW, CL_SWAPPED, VIEW_SWAPPED = 0, 1, 2, 3

_XFWD_CASES = [
    (2, 6, 21, 35, 16, VIEW, VIEW, ()),        # the 3D table: ragged tiles, NCDHW views
    (2, 5, 17, 19, 16, CL, CL, ()),            # the 3D step: channels-last both
    (1, 5, 17, 19, 16, CL, CL_SWAPPED, ()),    # the H/W-swapped teacher
    (1, 5, 17, 19, 16, CL, VIEW, ()),          # an NCDHW-view teacher
    (2, 3, 20, 25, 16, VIEW, CL, ()),          # D < 4, H, W < 27
    (1, 5, 17, 19, 8, CL, CL_SWAPPED, ()),     # C = 8
    (1, 5, 17, 19, 8, VIEW, CL, ()),
    (1, 7, 18, 20, 16, CL, VIEW, _ODD_OFFSETS),
    (2, 1, 37, 29, 16, VIEW, VIEW_SWAPPED, "n4"),  # D = 1: K4's offsets, the 2D swapped teacher
    (2, 1, 37, 29, 16, VIEW, VIEW, "n8"),          # neighbor 8's diagonals
]
_XFWD_IDS = ["view", "cl", "cl-swapped", "cl-view", "small", "c8", "c8-view-cl", "odd",
             "2d-n4-swapped", "2d-n8"]


def _table(offsets):
    return _offsets_2d(int(offsets[1:])) if isinstance(offsets, str) else offsets


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,la,lb,offsets", _XFWD_CASES, ids=_XFWD_IDS)
def test_cross_affinity_fwd_kernel_emulated(harness, b, d, h, w, c, la, lb, offsets, dtype):
    err, zeros = _run(harness, "xfwd", b, d, h, w, c, dtype, la, lb, *_table(offsets))
    assert err <= {0: 1e-6, 1: 8e-3}[dtype]
    assert zeros


_XBWD_CASES = [
    (2, 6, 21, 35, 16, VIEW, VIEW, 0, 0, ()),       # the 3D step's call: no db
    (2, 5, 17, 19, 16, CL, CL, 0, 1, ()),           # channels-last both, db
    (1, 5, 17, 19, 16, CL, CL_SWAPPED, 0, 1, ()),   # the H/W-swapped teacher
    (1, 5, 17, 19, 16, CL, VIEW, 0, 0, ()),
    (2, 3, 20, 25, 16, VIEW, CL, 0, 1, ()),         # D < 4, H, W < 27
    (1, 5, 17, 19, 8, CL, CL_SWAPPED, 0, 1, ()),    # C = 8
    (1, 5, 17, 19, 16, VIEW, CL, 1, 1, ()),         # raw
    (1, 7, 18, 20, 16, CL, VIEW, 0, 1, _ODD_OFFSETS),
    (2, 1, 37, 29, 16, VIEW, VIEW_SWAPPED, 0, 1, "n4"),  # D = 1: K4b
    (2, 1, 37, 29, 16, VIEW, VIEW, 0, 0, "n8"),
]
_XBWD_IDS = ["view", "cl-db", "cl-swapped-db", "cl-view", "small-db", "c8-db", "raw-db",
             "odd-db", "2d-n4-swapped-db", "2d-n8"]


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,la,lb,raw,db,offsets", _XBWD_CASES, ids=_XBWD_IDS)
def test_cross_affinity_bwd_kernel_emulated(harness, b, d, h, w, c, la, lb, raw, db, offsets,
                                            dtype):
    err, _ = _run(harness, "xbwd", b, d, h, w, c, dtype, la, lb, raw, db, *_table(offsets))
    assert err <= {0: 1e-5, 1: 8e-3}[dtype]


# 64 random 2D offsets (K1f's most), |dy|, |dx| <= 12, either sign
_MANY_2D = np.random.default_rng(5).integers(-12, 13, size=(64, 2)).tolist()


def _table_2d(table):
    """The (dy, dx) table of a 2D case: "n4" the main path's 10 offsets
    (neighbor 4 at shifts 1, 3, 5, 9, 27), "k1" its first, "n8" neighbor 8
    at shifts 1 and 3 (diagonals with dx > 0), "many" 64 random ones."""
    from pixel_embedded_affinity_torch.ops import multi_offset

    offs = {"n4": multi_offset([1, 3, 5, 9, 27], 4), "k1": multi_offset([1, 3, 5, 9, 27], 4)[:1],
            "n8": multi_offset([1, 3], 8), "many": _MANY_2D}[table]
    return [int(v) for o in offs for v in o]


# (B, H, W, C, layout, table) of K1f, each with a zero vector at (0, 3, 5)
# whose affinities must be exactly 0, as must those reaching outside
_K1F_CASES = [
    (2, 37, 29, 16, VIEW, "n4"),   # the NCHW view, ragged tiles
    (1, 20, 25, 16, VIEW, "n4"),   # H, W < 27: whole offsets outside
    (1, 21, 33, 8, VIEW, "n4"),    # C = 8
    (1, 21, 33, 16, VIEW, "n8"),   # neighbor 8's diagonals
    (2, 19, 35, 16, CL, "n4"),     # contiguous channels-last, loaded plane-wise
    (1, 23, 31, 16, VIEW, "many"),
]
_K1F_IDS = ["view", "small", "c8", "n8", "cl", "many"]


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,layout,table", _K1F_CASES, ids=_K1F_IDS)
def test_affinity2d_kernel_emulated(harness, b, h, w, c, layout, table, dtype):
    err, zeros = _run(harness, "k1f", b, h, w, c, dtype, layout, *_table_2d(table))
    assert err <= _TOL[dtype]
    assert zeros


# (B, H, W, cross, layout of a, layout of b, soft mask, table): the loss-fused
# WMSE kernels of csrc/affinity_wmse2d.cu (C = 16, float32); b's layout is
# unused by the self form
_WMSE_CASES = [
    (2, 37, 29, 0, VIEW, VIEW, 0, "n4"),          # the self loss: ragged tiles, the NCHW view
    (1, 20, 25, 0, VIEW, VIEW, 0, "n4"),          # H, W < 27: whole offsets outside
    (2, 19, 35, 0, VIEW, VIEW, 1, "k1"),          # K = 1, a non-binary mask
    (1, 21, 33, 0, VIEW, VIEW, 0, "n8"),          # diagonals with dx > 0
    (2, 37, 29, 1, VIEW, VIEW, 0, "n4"),          # the cross loss: the step's views
    (1, 37, 29, 1, VIEW, VIEW_SWAPPED, 1, "n4"),  # a teacher with H stride 1
    (1, 20, 25, 1, VIEW, VIEW, 0, "n4"),
    (2, 19, 35, 1, VIEW, VIEW, 1, "k1"),
    (1, 21, 33, 1, CL, CL, 0, "n8"),              # channels-last both, plane-wise loads
]
_WMSE_IDS = ["self", "self-small", "self-k1-soft", "self-n8", "cross", "cross-swapped-soft",
             "cross-small", "cross-k1-soft", "cross-cl-n8"]


def _with_dtypes(cases, ids):
    """Each case in float32 (dtype 0, its own id) and in bfloat16 (1, the id
    with "-bf16"), the dtype last."""
    return ([(*c, 0) for c in cases] + [(*c, 1) for c in cases],
            list(ids) + [f"{i}-bf16" for i in ids])


_WMSE_FWD_ALL, _WMSE_FWD_ALL_IDS = _with_dtypes(_WMSE_CASES, _WMSE_IDS)


@pytest.mark.parametrize("b,h,w,cross,la,lb,soft,table,dtype", _WMSE_FWD_ALL,
                         ids=_WMSE_FWD_ALL_IDS)
def test_wmse_fwd_kernel_emulated(harness, b, h, w, cross, la, lb, soft, table, dtype):
    """K2f/K3f: the affinities at 1e-5, or 8e-3 in bfloat16 (and exact zeros
    outside and at the zero vector), the sums S relative at 1e-5, both as
    the wrapper sums the block partials (float32) and as their float64
    sum."""
    proc = subprocess.run([harness, "wfwd", *map(str, (b, h, w, dtype, cross, la, lb, soft)),
                           *map(str, _table_2d(table))],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"abs_err (\S+) zeros_outside (\d) s_rel (\S+) partial_rel (\S+)", proc.stdout)
    err, zeros, s_rel, p_rel = float(m.group(1)), m.group(2) == "1", float(m.group(3)), float(m.group(4))
    assert err <= _TOL[dtype] and zeros
    assert s_rel <= 1e-5 and p_rel <= 1e-5


# (B, H, W, cross, layout of a, layout of b, db, soft mask, table): K2b, and
# K3b without db (the training step's call) and with it
_WMSE_BWD_CASES = [
    (2, 37, 29, 0, VIEW, VIEW, 0, 0, "n4"),
    (1, 20, 25, 0, VIEW, VIEW, 0, 0, "n4"),
    (2, 19, 35, 0, VIEW, VIEW, 0, 1, "k1"),
    (1, 21, 33, 0, VIEW, VIEW, 0, 0, "n8"),
    (2, 37, 29, 1, VIEW, VIEW, 0, 0, "n4"),
    (2, 37, 29, 1, VIEW, VIEW, 1, 0, "n4"),
    (1, 37, 29, 1, VIEW, VIEW_SWAPPED, 0, 1, "n4"),
    (1, 37, 29, 1, VIEW, VIEW_SWAPPED, 1, 1, "n4"),
    (1, 20, 25, 1, VIEW, VIEW, 1, 0, "n4"),
    (2, 19, 35, 1, VIEW, VIEW, 0, 1, "k1"),
    (2, 19, 35, 1, VIEW, VIEW, 1, 1, "k1"),
    (1, 21, 33, 1, CL, CL, 1, 0, "n8"),
]
_WMSE_BWD_IDS = _WMSE_IDS[:4] + ["cross", "cross-db", "cross-swapped-soft",
                                 "cross-swapped-soft-db", "cross-small-db", "cross-k1-soft",
                                 "cross-k1-soft-db", "cross-cl-n8-db"]


_WMSE_BWD_ALL, _WMSE_BWD_ALL_IDS = _with_dtypes(_WMSE_BWD_CASES, _WMSE_BWD_IDS)


@pytest.mark.parametrize("b,h,w,cross,la,lb,db,soft,table,dtype", _WMSE_BWD_ALL,
                         ids=_WMSE_BWD_ALL_IDS)
def test_wmse_bwd_kernel_emulated(harness, b, h, w, cross, la, lb, db, soft, table, dtype):
    """K2b/K3b: each gradient at 1e-5 (bfloat16: 8e-3) of its largest, and
    at the zero vector's pixel of its own largest."""
    err, _ = _run(harness, "wbwd", b, h, w, dtype, cross, la, lb, db, soft, *_table_2d(table))
    assert err <= _TOL[dtype]

