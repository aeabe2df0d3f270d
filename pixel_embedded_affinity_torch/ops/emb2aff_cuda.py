"""Fused embedding -> multi-offset affinity: the Hopper kernel and its wrapper.

``fused_affinity_2d`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py::fused_affinity_2d``
(forward). On a CUDA tensor it launches ``csrc/affinity2d.cu`` (built with
nvcc at first use, see :mod:`..cuda_build`); on a CPU tensor it runs the
plain version, :func:`affinity_2d_plain`. Design notes and the kernel's
bound are in the CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .emb2aff import embedding_to_affinity_2d

SOURCE = "affinity2d.cu"
SUPPORTED_C = (8, 16)
MAX_OFFSETS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def affinity_2d_plain(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 compute, 'valid'
    padding, output in the input's dtype."""
    affs = embedding_to_affinity_2d(embedding.float(), offsets, padding="valid")
    return affs.to(embedding.dtype)


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.affinity2d_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def fused_affinity_2d(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """(B, H, W, C) embedding -> (B, K, H, W) 'valid' affinities.

    Takes any strided view, e.g. ``emb_nchw.permute(0, 2, 3, 1)`` without a
    copy. ``fused_affinity_2d.launches`` counts kernel launches. Forward
    only on CUDA: an input that requires grad raises there (the plain
    version on the CPU is differentiable).
    """
    if embedding.dim() != 4:
        raise ValueError(f"embedding must be (B, H, W, C), got {tuple(embedding.shape)}")
    if embedding.device.type == "cpu":
        return affinity_2d_plain(embedding, offsets)
    if embedding.device.type != "cuda":
        raise ValueError(f"unsupported device {embedding.device}")
    if torch.is_grad_enabled() and embedding.requires_grad:
        # the output would carry no grad_fn and cut the graph silently
        raise NotImplementedError(
            "fused_affinity_2d has no gradient on CUDA: its backward kernel "
            "(K1b, emb2aff_pallas.py::_fused_affinity_2d_bwd_impl) is not "
            "ported; call it under torch.no_grad() or use "
            "embedding_to_affinity_2d")
    if embedding.dtype not in _DTYPES:
        raise TypeError(f"dtype {embedding.dtype} not supported (float32, bfloat16)")
    b, h, w, c = embedding.shape
    if c not in SUPPORTED_C:
        raise ValueError(f"C={c} not supported, expected one of {SUPPORTED_C}")
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1, 2))
    k = offs.shape[0]
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"{k} offsets, expected 1..{MAX_OFFSETS}")
    out = torch.empty((b, k, h, w), dtype=embedding.dtype, device=embedding.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(embedding.device).cuda_stream
    with torch.cuda.device(embedding.device):
        err = lib.affinity2d_fwd(
            embedding.data_ptr(), out.data_ptr(), _DTYPES[embedding.dtype],
            b, h, w, c, *embedding.stride(),
            offs.ctypes.data, k, stream)
    if err != 0:
        raise RuntimeError(f"affinity2d_fwd launch failed: cudaError {err}")
    fused_affinity_2d.launches += 1
    return out


fused_affinity_2d.launches = 0
