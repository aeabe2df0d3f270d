"""3D shift-table affinities, self and cross view: the Hopper kernels and
their wrappers.

``fused_affinity_3d`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py::fused_affinity_3d``
and ``fused_cross_affinity_3d`` that of ``fused_cross_affinity_3d``, each
with its backward. On CUDA tensors each is a ``torch.autograd.Function``:

* self: forward K5f (``csrc/affinity3d.cu``), backward ``affinity_bwd``;
* cross: forward ``cross_affinity_fwd`` (K6f), backward
  ``cross_affinity_bwd`` (K4b's function with the z terms); the teacher's
  gradient is skipped when it needs none;

the three launchers of ``csrc/affinity_grad.cu``, whose offsets are
(dz, dy, dx) per channel. At D = 1 they also serve the 2D wrappers of
:mod:`.emb2aff_cuda`: ``affinity_bwd`` K1's backward, ``cross_affinity_fwd``
K4f and ``cross_affinity_bwd`` K4's backward. The sources are built with nvcc at first
use (:mod:`..cuda_build`). On CPU tensors the wrappers run the plain
versions, differentiated by autograd. Each launcher counts its launches in
``.launches``; K5f's count is ``fused_affinity_3d.launches``. Design notes
and the kernels' bounds are in the CUDA sources.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .emb2aff import (cross_affinity_3d, embedding_to_affinity_3d, normalize_embedding,
                      offset_affinity_3d)
from .emb2aff_cuda import _DTYPES, SUPPORTED_C, _on_cpu
from .launch_count import counted
from .offsets import SHIFTS_3D, offsets_3d

SOURCE = "affinity3d.cu"
GRAD_SOURCE = "affinity_grad.cu"
MAX_SHIFTS = 64


def affinity_3d_plain(embedding: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 compute, zero where the
    neighbour is outside, output in the input's dtype."""
    return embedding_to_affinity_3d(embedding.float(), shifts).to(embedding.dtype)


def cross_affinity_3d_plain(a: torch.Tensor, b: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """K6f's function in plain PyTorch, as :func:`affinity_3d_plain`."""
    return cross_affinity_3d(a.float(), b.float(), shifts).to(a.dtype)


def _unit(e: torch.Tensor, normalized: bool) -> torch.Tensor:
    return e if normalized else normalize_embedding(e)


def affinity_bwd_plain(e: torch.Tensor, g: torch.Tensor, offsets,
                       normalized: bool = False) -> torch.Tensor:
    """``affinity_bwd``'s function in plain PyTorch: the gradient of
    sum(g * a) for a_k(p) = <n(p), n(p + o_k)>, by autograd in float32;
    with ``normalized`` e is taken as unit vectors and dn is returned."""
    x = e.detach().float().requires_grad_()
    with torch.enable_grad():
        n = _unit(x, normalized)
        a = offset_affinity_3d(n, n, offsets)
        (de,) = torch.autograd.grad(a, x, g.float())
    return de.to(e.dtype)


def cross_affinity_bwd_plain(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, offsets,
                             normalized: bool = False):
    """``cross_affinity_bwd``'s function in plain PyTorch: (da, db)."""
    xa = a.detach().float().requires_grad_()
    xb = b.detach().float().requires_grad_()
    with torch.enable_grad():
        aff = offset_affinity_3d(_unit(xa, normalized), _unit(xb, normalized), offsets)
        da, db = torch.autograd.grad(aff, (xa, xb), g.float())
    return da.to(a.dtype), db.to(b.dtype)


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


def _grad_lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(GRAD_SOURCE)
    if lib.affinity_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        shape = [i] * 5  # B, D, H, W, C
        for name, args in [
                ("affinity_bwd", [p, p, p, p, i] + shape + [p, i, i, p]),
                ("cross_affinity_fwd", [p] * 5 + [i] + shape + [p, i, p]),
                ("cross_affinity_bwd", [p] * 7 + [i] + shape + [p, i, i, p])]:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _check(embs, offsets):
    """Devices, types and shapes the kernels take; returns the offsets as a
    contiguous int32 (K, 3) array."""
    e0 = embs[0]
    if e0.dim() != 5:
        raise ValueError(f"embedding must be (B, D, H, W, C), got {tuple(e0.shape)}")
    for x in embs:
        if x.device.type != "cuda" or x.device != e0.device:
            raise ValueError(f"all inputs must be on one CUDA device, got {x.device}")
        if x.dtype not in _DTYPES or x.dtype != e0.dtype:
            raise TypeError(f"dtype {x.dtype} not supported (float32 or bfloat16, one for all)")
        if x.shape != e0.shape:
            raise ValueError(f"embedding shapes differ: {tuple(x.shape)} vs {tuple(e0.shape)}")
    if e0.shape[-1] not in SUPPORTED_C:
        raise ValueError(f"C={e0.shape[-1]} not supported, expected one of {SUPPORTED_C}")
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1, 3))
    if not 1 <= offs.shape[0] <= MAX_SHIFTS:
        raise ValueError(f"{offs.shape[0]} offsets, expected 1..{MAX_SHIFTS}")
    return offs


def _strides(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x.stride(), dtype=np.int64)


def _cotangent(g: torch.Tensor, e: torch.Tensor, k: int) -> torch.Tensor:
    b, d, h, w, _ = e.shape
    if g.shape != (b, k, d, h, w):
        raise ValueError(f"g must be {(b, k, d, h, w)}, got {tuple(g.shape)}")
    return g.to(device=e.device, dtype=e.dtype).contiguous()


def _launch(name: str, dev, *args):
    with torch.cuda.device(dev):
        err = getattr(_grad_lib(), name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _grad_buffer(e: torch.Tensor) -> torch.Tensor:
    """A contiguous (B, C, D, H, W) buffer, the layout of the model's NCDHW
    gradient; the kernels write it, the caller gets its (B, D, H, W, C) view."""
    b, d, h, w, c = e.shape
    return torch.empty((b, c, d, h, w), dtype=e.dtype, device=e.device)


def affinity_bwd(e: torch.Tensor, g: torch.Tensor, offsets,
                 normalized: bool = False) -> torch.Tensor:
    """K5b (and K1b at D = 1): de of a CUDA (B, D, H, W, C) view for the
    cotangent g (B, K, D, H, W) of a_k(p) = <n(p), n(p + offsets[k])>."""
    offs = _check([e], offsets)
    g = _cotangent(g, e, offs.shape[0])
    de = _grad_buffer(e)
    if de.numel():
        se = _strides(e)
        _launch("affinity_bwd", e.device, e.data_ptr(), se.ctypes.data, g.data_ptr(),
                de.data_ptr(), _DTYPES[e.dtype], *e.shape, offs.ctypes.data, offs.shape[0],
                int(normalized))
        affinity_bwd.launches += 1
    return de.permute(0, 2, 3, 4, 1)


def _cross_fwd(a: torch.Tensor, b: torch.Tensor, offs: np.ndarray) -> torch.Tensor:
    """One launch of ``cross_affinity_fwd`` on checked views, counted by the
    caller: K6f's and, at D = 1, K4f's (:mod:`.emb2aff_cuda`)."""
    bs, d, h, w, _ = a.shape
    out = torch.empty((bs, offs.shape[0], d, h, w), dtype=a.dtype, device=a.device)
    if out.numel():
        sa, sb = _strides(a), _strides(b)
        _launch("cross_affinity_fwd", a.device, a.data_ptr(), sa.ctypes.data, b.data_ptr(),
                sb.ctypes.data, out.data_ptr(), _DTYPES[a.dtype], *a.shape, offs.ctypes.data,
                offs.shape[0])
    return out


def cross_affinity_fwd(a: torch.Tensor, b: torch.Tensor, offsets) -> torch.Tensor:
    """K6f: (B, K, D, H, W) <n_a(p), n_b(p + offsets[k])> of CUDA views."""
    out = _cross_fwd(a, b, _check([a, b], offsets))
    if out.numel():
        cross_affinity_fwd.launches += 1
    return out


def cross_affinity_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, offsets,
                       need_db: bool = True, normalized: bool = False):
    """K6b: (da, db) of the cross affinities for the cotangent g; db is None
    unless ``need_db``."""
    offs = _check([a, b], offsets)
    g = _cotangent(g, a, offs.shape[0])
    da = _grad_buffer(a)
    db = _grad_buffer(b) if need_db else None
    if da.numel():
        sa, sb = _strides(a), _strides(b)
        _launch("cross_affinity_bwd", a.device, a.data_ptr(), sa.ctypes.data, b.data_ptr(),
                sb.ctypes.data, g.data_ptr(), da.data_ptr(),
                db.data_ptr() if need_db else None, _DTYPES[a.dtype], *a.shape,
                offs.ctypes.data, offs.shape[0], int(normalized))
        cross_affinity_bwd.launches += 1
    return (da.permute(0, 2, 3, 4, 1),
            db.permute(0, 2, 3, 4, 1) if need_db else None)


counted(affinity_bwd, cross_affinity_fwd, cross_affinity_bwd)


def _affinity_3d_fwd(embedding: torch.Tensor, shifts) -> torch.Tensor:
    """K5f on a CUDA (B, D, H, W, C) view."""
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


class _Affinity3D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, shifts):
        ctx.save_for_backward(e)
        ctx.shifts = shifts
        return _affinity_3d_fwd(e, shifts)

    @staticmethod
    def backward(ctx, g):
        (e,) = ctx.saved_tensors
        return affinity_bwd(e, g, offsets_3d(ctx.shifts)), None


class _CrossAffinity3D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, shifts):
        ctx.save_for_backward(a, b)
        ctx.shifts = shifts
        return cross_affinity_fwd(a, b, offsets_3d(shifts))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = cross_affinity_bwd(a, b, g, offsets_3d(ctx.shifts),
                                    need_db=ctx.needs_input_grad[1])
        return (da if ctx.needs_input_grad[0] else None), db, None


def _shifts(shifts) -> tuple:
    return tuple(int(s) for s in shifts)


def fused_affinity_3d(embedding: torch.Tensor, shifts=SHIFTS_3D) -> torch.Tensor:
    """(B, D, H, W, C) embedding -> (B, K, D, H, W) affinities; channel k
    shifts axis k % 3 of (z, y, x) back by ``shifts[k]``.

    Takes any strided view, e.g. ``emb_ncdhw.permute(0, 2, 3, 4, 1)``
    without a copy; the gradient comes back in the NCDHW layout.
    ``fused_affinity_3d.launches`` counts K5f's launches.
    """
    if embedding.dim() != 5:
        raise ValueError(f"embedding must be (B, D, H, W, C), got {tuple(embedding.shape)}")
    if _on_cpu(embedding):
        return affinity_3d_plain(embedding, shifts)
    return _Affinity3D.apply(embedding, _shifts(shifts))


def fused_cross_affinity_3d(a: torch.Tensor, b: torch.Tensor,
                            shifts=SHIFTS_3D) -> torch.Tensor:
    """(student a, teacher b) (B, D, H, W, C) -> (B, K, D, H, W) cross
    affinities <n_a(p), n_b(p - s_k e_{k%3})>. b gets a gradient only if it
    requires one (the train step's teacher is detached)."""
    if a.dim() != 5:
        raise ValueError(f"embedding must be (B, D, H, W, C), got {tuple(a.shape)}")
    if _on_cpu(a):
        return cross_affinity_3d_plain(a, b, shifts)
    return _CrossAffinity3D.apply(a, b, _shifts(shifts))


counted(fused_affinity_3d)
