"""The staged z-walk forms of the two 3D affinity kernels,
``tools/affinity_zwalk.cu`` (the design that ``tools/affinity_zwalk.py``
times against the package's kernels), compiled with g++ against
``tests/cuda_emu`` and held against float64 as
``test_torch_kernel_emulation.py`` holds the package's K5f and
``affinity_bwd``: its cases, and a walk over z chunks and tables longer
than the staged cotangents. A file of its own so that tier 1's workers
share the emulation's builds and runs."""

import numpy as np
import pytest

from test_torch_kernel_emulation import (ZWALK, _BWD_CASES, _BWD_IDS, _K5F_CASES, _K5F_IDS,
                                         _build, _bwd, _run)


@pytest.fixture(scope="module")
def harness_zwalk(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("cuda_emu_zwalk"), [ZWALK])


# 40 random shifts and offsets, |dz| <= 5, |dy|, |dx| <= 12: far terms
# beyond those read ahead, and (backward, C = 16) more channels than the
# staged cotangents; 18 slices on a 9 x 33 slice: three z chunks on the
# emulated card's three SMs, each warming its ring up
_RNG = np.random.default_rng(3)
_MANY_SHIFTS = tuple(int(v) for v in _RNG.integers(-12, 13, size=40))
_MANY_OFFSETS = tuple(int(v) for _ in range(40) for v in (
    _RNG.integers(-5, 6), _RNG.integers(-12, 13), _RNG.integers(-12, 13)))


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,layout,shifts", _K5F_CASES + [
    (1, 7, 18, 20, 16, 1, _MANY_SHIFTS),
    (1, 18, 9, 33, 16, 1, ()),
], ids=_K5F_IDS + ["many-shifts", "z-chunks"])
def test_zwalk_affinity3d_kernel_emulated(harness_zwalk, b, d, h, w, c, layout, shifts, dtype):
    err, zeros = _run(harness_zwalk, "k5f", b, d, h, w, c, dtype, layout, *shifts)
    assert err <= {0: 1e-6, 1: 8e-3}[dtype]
    assert zeros


@pytest.mark.parametrize("dtype", [0, 1], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,d,h,w,c,layout,raw,offsets", _BWD_CASES + [
    (1, 7, 18, 20, 16, 1, 0, _MANY_OFFSETS),
    (1, 18, 9, 33, 16, 0, 0, ()),
], ids=_BWD_IDS + ["many-offsets", "z-chunks"])
def test_zwalk_affinity_bwd_kernel_emulated(harness_zwalk, b, d, h, w, c, layout, raw, offsets,
                                            dtype):
    _bwd(harness_zwalk, b, d, h, w, c, layout, raw, offsets, dtype)
