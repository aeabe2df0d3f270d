"""The tile copy of the arrangement probe: the Hopper kernel of
``csrc/tile_copy.cu`` (P) and its wrapper.

``tile_copy`` is the port of the TPU kernel ``_id_kernel`` (``pallas_copy``
in ``docs/profile_b1_arrange.py``): an identity copy of a tensor in
``shape[tile_axis] // tile`` blocks of ``tile`` rows along ``tile_axis``.
Where ``shape[tile_axis]`` is not a multiple of ``tile`` the TPU kernel
leaves the remainder of its output unwritten; the port raises instead of
returning memory that was never written, so the copy covers the whole
tensor. The tensor is contiguous, of any dtype (the kernel counts bytes);
the probe passes the embedding and its permutations made contiguous, as
the TPU script's transposes make them. On a CUDA tensor it launches the
kernel; on a CPU tensor it runs :func:`tile_copy_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .launch_count import counted

SOURCE = "tile_copy.cu"


def _check(t: torch.Tensor, tile_axis: int, tile: int):
    if not 0 <= tile_axis < t.dim():
        raise ValueError(f"tile_axis {tile_axis} out of range for a rank-{t.dim()} tensor")
    if tile < 1 or t.shape[tile_axis] % tile:
        raise ValueError(f"shape[{tile_axis}] = {t.shape[tile_axis]} is not a multiple of the "
                         f"tile {tile}: the remainder would be left unwritten")
    if not t.is_contiguous():
        raise ValueError(f"the tensor must be contiguous, got strides {t.stride()}")


def tile_copy_plain(t: torch.Tensor, tile_axis: int = 1, tile: int = 32) -> torch.Tensor:
    """P's function in plain PyTorch: a clone of the covered region, the
    whole tensor."""
    _check(t, tile_axis, tile)
    return t.clone()


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.tile_copy
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    return lib


def tile_copy(t: torch.Tensor, tile_axis: int = 1, tile: int = 32) -> torch.Tensor:
    """P: a copy of ``t`` (contiguous, ``shape[tile_axis]`` a multiple of
    ``tile``). ``tile_copy.launches`` counts its launches."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.device.type == "cpu":
        return tile_copy_plain(t, tile_axis, tile)
    _check(t, tile_axis, tile)
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return out
    stream = torch.cuda.current_stream(t.device).cuda_stream
    with torch.cuda.device(t.device):
        err = _lib().tile_copy(t.data_ptr(), out.data_ptr(), nbytes, stream)
    if err != 0:
        raise RuntimeError(f"tile_copy launch failed: cudaError {err}")
    tile_copy.launches += 1
    return out


counted(tile_copy)
