"""Fused embedding -> 3D shift-table affinity: the Hopper kernel and its wrapper.

``fused_affinity_3d`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py::fused_affinity_3d``
(forward). On a CUDA tensor it launches ``csrc/affinity3d.cu`` (built with
nvcc at first use, see :mod:`..cuda_build`); on a CPU tensor it runs the
plain version, :func:`affinity_3d_plain`. Design notes and the kernel's
bound are in the CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .emb2aff import embedding_to_affinity_3d
from .emb2aff_cuda import _DTYPES, SUPPORTED_C
from .offsets import SHIFTS_3D

SOURCE = "affinity3d.cu"
MAX_SHIFTS = 64


def affinity_3d_plain(embedding: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 compute, zero where the
    neighbour is outside, output in the input's dtype."""
    return embedding_to_affinity_3d(embedding.float(), shifts).to(embedding.dtype)


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.affinity3d_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_int] * 5 + [ctypes.c_int64] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def fused_affinity_3d(embedding: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """(B, D, H, W, C) embedding -> (B, K, D, H, W) affinities; channel k
    shifts axis k % 3 of (z, y, x) back by ``shifts[k]``.

    Takes any strided view, e.g. ``emb_ncdhw.permute(0, 2, 3, 4, 1)``
    without a copy. ``fused_affinity_3d.launches`` counts kernel launches.
    Forward only on CUDA: an input that requires grad raises there (the
    plain version on the CPU is differentiable).
    """
    if embedding.dim() != 5:
        raise ValueError(f"embedding must be (B, D, H, W, C), got {tuple(embedding.shape)}")
    if embedding.device.type == "cpu":
        return affinity_3d_plain(embedding, shifts)
    if embedding.device.type != "cuda":
        raise ValueError(f"unsupported device {embedding.device}")
    if torch.is_grad_enabled() and embedding.requires_grad:
        # the output would carry no grad_fn and cut the graph silently
        raise NotImplementedError(
            "fused_affinity_3d has no gradient on CUDA: its backward (K1b over "
            "B*D slices plus the z-slab adds, emb2aff_pallas.py::"
            "_fused_affinity_3d_bwd) is not ported; call it under "
            "torch.no_grad() or use embedding_to_affinity_3d")
    if embedding.dtype not in _DTYPES:
        raise TypeError(f"dtype {embedding.dtype} not supported (float32, bfloat16)")
    b, d, h, w, c = embedding.shape
    if c not in SUPPORTED_C:
        raise ValueError(f"C={c} not supported, expected one of {SUPPORTED_C}")
    sh = np.ascontiguousarray(np.asarray(shifts, dtype=np.int32).reshape(-1))
    k = sh.shape[0]
    if not 1 <= k <= MAX_SHIFTS:
        raise ValueError(f"{k} shifts, expected 1..{MAX_SHIFTS}")
    out = torch.empty((b, k, d, h, w), dtype=embedding.dtype, device=embedding.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(embedding.device).cuda_stream
    with torch.cuda.device(embedding.device):
        err = lib.affinity3d_fwd(
            embedding.data_ptr(), out.data_ptr(), _DTYPES[embedding.dtype],
            b, d, h, w, c, *embedding.stride(), sh.ctypes.data, k, stream)
    if err != 0:
        raise RuntimeError(f"affinity3d_fwd launch failed: cudaError {err}")
    fused_affinity_3d.launches += 1
    return out


fused_affinity_3d.launches = 0
