"""Fused embedding -> multi-offset affinity, self and cross view, in 2D:
the Hopper kernels and their wrappers.

``fused_affinity_2d`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py::fused_affinity_2d``
(K1), and ``fused_cross_affinity_2d`` that of ``fused_cross_affinity_2d``
(K4), each forward and backward. On CUDA tensors each is a
``torch.autograd.Function``:

* self: the forward launches ``csrc/affinity2d.cu`` (K1f), the backward
  the self-affinity backward kernel of ``csrc/affinity_grad.cu`` at D = 1
  (:func:`.emb2aff3d_cuda.affinity_bwd`, K1b's function);
* cross: the forward launches ``cross_affinity_fwd`` of
  ``csrc/affinity_grad.cu`` at D = 1 (K4f), the backward
  ``cross_affinity_bwd`` at D = 1 (K4b's function), the teacher's gradient
  skipped when it needs none.

The 2D offsets (dy, dx) go to the 3D kernels as (0, dy, dx) on the
(B, 1, H, W, C) views. The sources are built with nvcc at first use (see
:mod:`..cuda_build`). On CPU tensors the wrappers run the plain versions,
:func:`affinity_2d_plain` and :func:`cross_affinity_2d_plain`,
differentiated by autograd. Design notes and the kernels' bounds are in the
CUDA sources.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .emb2aff import cross_affinity_2d, embedding_to_affinity_2d
from .launch_count import counted

SOURCE = "affinity2d.cu"
SUPPORTED_C = (8, 16)
MAX_OFFSETS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def affinity_2d_plain(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 compute, 'valid'
    padding, output in the input's dtype."""
    affs = embedding_to_affinity_2d(embedding.float(), offsets, padding="valid")
    return affs.to(embedding.dtype)


def cross_affinity_2d_plain(a: torch.Tensor, b: torch.Tensor, offsets) -> torch.Tensor:
    """K4f's function in plain PyTorch: (B, K, H, W) <n_a(p), n_b(p + o_k)>,
    f32 compute, 'valid' padding, output in a's dtype."""
    return cross_affinity_2d(a.float(), b.float(), offsets).to(a.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signature of a build of SOURCE's C entry, once;
    returns lib."""
    fn = lib.affinity2d_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    return bind(cuda_build.load(SOURCE))


def _affinity_2d_fwd(embedding: torch.Tensor, offsets, lib=None) -> torch.Tensor:
    """K1f on a CUDA (B, H, W, C) view, launched from the package's build
    or from ``lib``, another build of SOURCE's C interface (``bind``)."""
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
    lib = _lib() if lib is None else lib
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
        return affinity_bwd(e[:, None], g[:, :, None], _offsets_3d(ctx.offsets))[:, 0], None


def _offsets_3d(offsets) -> list:
    return [(0, dy, dx) for dy, dx in offsets]


class _CrossAffinity2D(torch.autograd.Function):
    """Forward K4f, backward K4b's function: the 3D cross kernels at D = 1."""

    @staticmethod
    def forward(ctx, a, b, offsets):
        from .emb2aff3d_cuda import _check, _cross_fwd

        ctx.save_for_backward(a, b)
        ctx.offsets = offsets
        a3, b3 = a[:, None], b[:, None]
        out = _cross_fwd(a3, b3, _check([a3, b3], _offsets_3d(offsets)))
        if out.numel():
            fused_cross_affinity_2d.launches += 1
        return out[:, :, 0]

    @staticmethod
    def backward(ctx, g):
        from .emb2aff3d_cuda import cross_affinity_bwd

        a, b = ctx.saved_tensors
        da, db = cross_affinity_bwd(a[:, None], b[:, None], g[:, :, None],
                                    _offsets_3d(ctx.offsets), need_db=ctx.needs_input_grad[1])
        return (da[:, 0] if ctx.needs_input_grad[0] else None,
                db[:, 0] if db is not None else None, None)


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def _pairs(offsets) -> tuple:
    return tuple((int(o[0]), int(o[1])) for o in offsets)


def fused_cross_affinity_2d(a_bhwc: torch.Tensor, b_bhwc: torch.Tensor,
                            offsets) -> torch.Tensor:
    """(student a, teacher b) (B, H, W, C) -> (B, K, H, W) 'valid' cross
    affinities <n_a(p), n_b(p + offsets[k])>.

    Takes any strided views (the teacher's un-flipped embedding comes with
    its x and y strides swapped); the gradients come back in the NCHW
    layout, and b gets one only if it requires one (the train step's
    teacher is detached). ``fused_cross_affinity_2d.launches`` counts K4f's
    launches.
    """
    if a_bhwc.dim() != 4 or b_bhwc.shape != a_bhwc.shape:
        raise ValueError(f"embeddings must be one (B, H, W, C) shape, got "
                         f"{tuple(a_bhwc.shape)}, {tuple(b_bhwc.shape)}")
    if _on_cpu(a_bhwc):
        return cross_affinity_2d_plain(a_bhwc, b_bhwc, offsets)
    return _CrossAffinity2D.apply(a_bhwc, b_bhwc, _pairs(offsets))


def fused_affinity_2d(embedding: torch.Tensor, offsets) -> torch.Tensor:
    """(B, H, W, C) embedding -> (B, K, H, W) 'valid' affinities.

    Takes any strided view, e.g. ``emb_nchw.permute(0, 2, 3, 1)`` without a
    copy; the gradient comes back in the NCHW layout.
    ``fused_affinity_2d.launches`` counts K1f's launches.
    """
    if embedding.dim() != 4:
        raise ValueError(f"embedding must be (B, H, W, C), got {tuple(embedding.shape)}")
    if _on_cpu(embedding):
        return affinity_2d_plain(embedding, offsets)
    return _Affinity2D.apply(embedding, _pairs(offsets))


counted(fused_affinity_2d, fused_cross_affinity_2d)
