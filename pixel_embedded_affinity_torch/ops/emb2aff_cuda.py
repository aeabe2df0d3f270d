"""Fused embedding -> multi-offset affinity: the Hopper kernel and its wrapper.

``fused_affinity_2d`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py::fused_affinity_2d``,
forward and backward. On a CUDA tensor it is a ``torch.autograd.Function``:
the forward launches ``csrc/affinity2d.cu`` (built with nvcc at first use,
see :mod:`..cuda_build`), the backward the self-affinity backward kernel of
``csrc/affinity_grad.cu`` at D = 1 (:func:`.emb2aff3d_cuda.affinity_bwd`).
On a CPU tensor it runs the plain version, :func:`affinity_2d_plain`,
differentiated by autograd. Design notes and the kernels' bounds are in
the CUDA sources.
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


def _affinity_2d_fwd(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """K1f on a CUDA (B, H, W, C) view."""
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


class _Affinity2D(torch.autograd.Function):
    """Forward K1f; backward the 3D self-affinity backward kernel at D = 1,
    the offsets (dy, dx) taken as (0, dy, dx)."""

    @staticmethod
    def forward(ctx, e, offsets):
        ctx.save_for_backward(e)
        ctx.offsets = offsets
        return _affinity_2d_fwd(e, offsets)

    @staticmethod
    def backward(ctx, g):
        from .emb2aff3d_cuda import affinity_bwd

        (e,) = ctx.saved_tensors
        offs = [(0, dy, dx) for dy, dx in ctx.offsets]
        return affinity_bwd(e[:, None], g[:, :, None], offs)[:, 0], None


def fused_affinity_2d(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """(B, H, W, C) embedding -> (B, K, H, W) 'valid' affinities.

    Takes any strided view, e.g. ``emb_nchw.permute(0, 2, 3, 1)`` without a
    copy; the gradient comes back in the NCHW layout.
    ``fused_affinity_2d.launches`` counts K1f's launches.
    """
    if embedding.dim() != 4:
        raise ValueError(f"embedding must be (B, H, W, C), got {tuple(embedding.shape)}")
    if embedding.device.type == "cpu":
        return affinity_2d_plain(embedding, offsets)
    if embedding.device.type != "cuda":
        raise ValueError(f"unsupported device {embedding.device}")
    return _Affinity2D.apply(embedding, tuple((int(o[0]), int(o[1])) for o in offsets))


fused_affinity_2d.launches = 0
