"""Loss-fused embedding -> affinity WMSE: the Hopper kernels K2 and K3.

``fused_affinity_wmse_2d`` and ``fused_cross_affinity_wmse_2d`` are the
ports of the TPU kernels of the same names in
``pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py`` (forward and
backward). Each returns ``(S, affs)``: the per-offset sums
``S_k = sum w_k (a_k m_k - t_k m_k)^2`` over batch and pixels, (K,), and
the 'valid' affinities (B, K, H, W). Gradients flow through S only; the
affinities are for monitoring and are marked non-differentiable, as in the
JAX contract. t, w and m get no gradient. The embeddings are float32 or
bfloat16 (one dtype for both), t, w and m float32: the kernels compute in
float32 and take S from the unrounded affinities, and write the affinities
and the gradients in the embeddings' dtype, as the TPU kernels do.

On a CUDA tensor each is a ``torch.autograd.Function`` whose forward
launches K2f/K3f and whose backward launches K2b/K3b, all in
``csrc/affinity_wmse2d.cu`` (built with nvcc at first use, see
:mod:`..cuda_build`). K3b computes the teacher's gradient db only when the
teacher needs one (``b.requires_grad``); the training step's teacher is
detached, so its backward gathers only the student's side and writes da.
On a CPU tensor each runs its plain version, written with :mod:`.emb2aff`
and differentiated by autograd. The four launchers ``wmse2d_fwd``,
``wmse2d_bwd``, ``cross_wmse2d_fwd`` and ``cross_wmse2d_bwd`` each count
their launches in ``.launches``. Design notes and the kernels' bounds are
in the CUDA source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .emb2aff import cross_affinity_2d, embedding_to_affinity_2d
from .launch_count import counted

SOURCE = "affinity_wmse2d.cu"
SUPPORTED_C = (16,)  # the cvppp preset's emd, the one width training runs
MAX_OFFSETS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _wmse_sums(affs, t, w, m):
    d = affs * m - t * m
    return torch.sum(w * d * d, dim=(0, 2, 3))


def _widened(e: torch.Tensor) -> torch.Tensor:
    """e in float32 at least: a bfloat16 embedding widened (autograd
    returns its gradient in bfloat16), float32 and float64 as they are."""
    return e.to(torch.promote_types(e.dtype, torch.float32))


def affinity_wmse_2d_plain(e: torch.Tensor, t, w, m, offsets):
    """K2's function in plain PyTorch: (S (K,), affs (B, K, H, W)),
    computed in float32 from a bfloat16 embedding; S from the unrounded
    affinities, the affinities in e's dtype."""
    affs = embedding_to_affinity_2d(_widened(e), offsets, padding="valid")
    return _wmse_sums(affs, t, w, m), affs.detach().to(e.dtype)


def cross_affinity_wmse_2d_plain(a: torch.Tensor, b: torch.Tensor, t, w, m, offsets):
    """K3's function in plain PyTorch: (S (K,), affs (B, K, H, W)), computed
    as :func:`affinity_wmse_2d_plain`'s, the affinities in a's dtype."""
    affs = cross_affinity_2d(_widened(a), _widened(b), offsets)
    return _wmse_sums(affs, t, w, m), affs.detach().to(a.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of a build of SOURCE's C entries, once;
    returns lib."""
    if lib.wmse2d_fwd.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        view = [p, i64, i64, i64, i64]
        tail = [i, i, i, i, i, p, i, p]  # dtype, B, H, W, C, offsets, K, stream
        lib.wmse2d_partial_rows.restype = i64
        lib.wmse2d_partial_rows.argtypes = [i, i, i]
        for name, args in [("wmse2d_fwd", view + [p] * 5),
                           ("cross_wmse2d_fwd", view + view + [p] * 5),
                           ("wmse2d_bwd", view + [p] * 5),
                           ("cross_wmse2d_bwd", view + view + [p] * 6)]:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args + tail
    return lib


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    return bind(cuda_build.load(SOURCE))


def _check(embs, maps, offsets):
    """Shapes, devices and types the kernels take; returns the offsets as
    a contiguous int32 (K, 2) array."""
    e0 = embs[0]
    if e0.dim() != 4:
        raise ValueError(f"embedding must be (B, H, W, C), got {tuple(e0.shape)}")
    b, h, w, c = e0.shape
    offs = np.ascontiguousarray(np.asarray(offsets, dtype=np.int32).reshape(-1, 2))
    k = offs.shape[0]
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"{k} offsets, expected 1..{MAX_OFFSETS}")
    if c not in SUPPORTED_C:
        raise ValueError(f"C={c} not supported, expected one of {SUPPORTED_C}")
    for x in embs:
        if x.shape != e0.shape:
            raise ValueError(f"embedding shapes differ: {tuple(x.shape)} vs {tuple(e0.shape)}")
    for x in maps:
        if x.shape != (b, k, h, w):
            raise ValueError(f"target/weight/mask must be {(b, k, h, w)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("target/weight/mask must be contiguous")
    for x in (*embs, *maps):
        if x.device != e0.device or x.device.type != "cuda":
            raise ValueError(f"all inputs must be on one CUDA device, got {x.device}")
    for x in embs:
        if x.dtype not in _DTYPES or x.dtype != e0.dtype:
            raise TypeError(f"embedding dtype {x.dtype} not supported (float32 or bfloat16, "
                            "one for both)")
    for x in maps:
        if x.dtype != torch.float32:
            raise TypeError(f"target/weight/mask dtype {x.dtype} not supported (float32)")
    return offs


def _launch(lib: ctypes.CDLL, name: str, *args):
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _fwd(entry: str, embs, t, w, m, offsets, lib=None):
    """Launch a forward entry of the package's build, or of ``lib``, another
    build of SOURCE's C interface (``bind``): (S (K,), affs (B, K, H, W))."""
    lib = _lib() if lib is None else lib
    offs = _check(embs, [t, w, m], offsets)
    b, h, wd, c = embs[0].shape
    k = offs.shape[0]
    dev = embs[0].device
    affs = torch.empty((b, k, h, wd), dtype=embs[0].dtype, device=dev)
    partial = torch.empty((lib.wmse2d_partial_rows(b, h, wd), k),
                          dtype=torch.float32, device=dev)
    views = [v for e in embs for v in (e.data_ptr(), *e.stride())]
    with torch.cuda.device(dev):
        _launch(lib, entry, *views, t.data_ptr(), w.data_ptr(), m.data_ptr(),
                affs.data_ptr(), partial.data_ptr(), _DTYPES[embs[0].dtype], b, h, wd, c,
                offs.ctypes.data, k, torch.cuda.current_stream(dev).cuda_stream)
    return partial.sum(dim=0), affs


def _bwd(entry: str, embs, t, w, m, g_s, offsets, n_grads: int, lib=None):
    """Launch a backward entry (of ``lib`` as in ``_fwd``): the gradients of
    the first ``n_grads`` embeddings in the embeddings' dtype, each written
    to a contiguous (B, C, H, W) buffer and returned as its (B, H, W, C)
    view, the layout of the model's NCHW gradient; the entry gets a null
    pointer for each gradient skipped."""
    lib = _lib() if lib is None else lib
    offs = _check(embs, [t, w, m], offsets)
    b, h, wd, c = embs[0].shape
    k = offs.shape[0]
    dev = embs[0].device
    g_s = g_s.to(device=dev, dtype=torch.float32).contiguous()
    if g_s.shape != (k,):
        raise ValueError(f"gS must be ({k},), got {tuple(g_s.shape)}")
    dtype = embs[0].dtype
    grads = [torch.empty((b, c, h, wd), dtype=dtype, device=dev) for _ in range(n_grads)]
    ptrs = [g.data_ptr() for g in grads] + [None] * (len(embs) - n_grads)
    views = [v for e in embs for v in (e.data_ptr(), *e.stride())]
    with torch.cuda.device(dev):
        _launch(lib, entry, *views, t.data_ptr(), w.data_ptr(), m.data_ptr(), g_s.data_ptr(),
                *ptrs, _DTYPES[dtype], b, h, wd, c, offs.ctypes.data, k,
                torch.cuda.current_stream(dev).cuda_stream)
    return [g.permute(0, 2, 3, 1) for g in grads]


def wmse2d_fwd(e, t, w, m, offsets):
    """K2f: (S (K,), affs (B, K, H, W)) of a CUDA (B, H, W, C) view."""
    out = _fwd("wmse2d_fwd", [e], t, w, m, offsets)
    wmse2d_fwd.launches += 1
    return out


def cross_wmse2d_fwd(a, b, t, w, m, offsets):
    """K3f: (S (K,), affs) of CUDA (B, H, W, C) views a (student), b (teacher)."""
    out = _fwd("cross_wmse2d_fwd", [a, b], t, w, m, offsets)
    cross_wmse2d_fwd.launches += 1
    return out


def wmse2d_bwd(e, t, w, m, g_s, offsets):
    """K2b: d(sum_k gS_k S_k)/de."""
    (de,) = _bwd("wmse2d_bwd", [e], t, w, m, g_s, offsets, 1)
    wmse2d_bwd.launches += 1
    return de


def cross_wmse2d_bwd(a, b, t, w, m, g_s, offsets, need_db: bool = True):
    """K3b: (da, db), or (da, None) without ``need_db``: the kernel then
    gathers only b's neighbours of each pixel and allocates and writes no
    db."""
    grads = _bwd("cross_wmse2d_bwd", [a, b], t, w, m, g_s, offsets, 2 if need_db else 1)
    cross_wmse2d_bwd.launches += 1
    return grads[0], (grads[1] if need_db else None)


counted(wmse2d_fwd, wmse2d_bwd, cross_wmse2d_fwd, cross_wmse2d_bwd)


class _AffinityWMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, t, w, m, offsets):
        s, affs = wmse2d_fwd(e, t, w, m, offsets)
        ctx.save_for_backward(e, t, w, m)
        ctx.offsets = offsets
        ctx.mark_non_differentiable(affs)
        return s, affs

    @staticmethod
    def backward(ctx, g_s, _g_affs):
        e, t, w, m = ctx.saved_tensors
        return wmse2d_bwd(e, t, w, m, g_s, ctx.offsets), None, None, None, None


class _CrossAffinityWMSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, t, w, m, offsets):
        s, affs = cross_wmse2d_fwd(a, b, t, w, m, offsets)
        ctx.save_for_backward(a, b, t, w, m)
        ctx.offsets = offsets
        ctx.mark_non_differentiable(affs)
        return s, affs

    @staticmethod
    def backward(ctx, g_s, _g_affs):
        a, b, t, w, m = ctx.saved_tensors
        da, db = cross_wmse2d_bwd(a, b, t, w, m, g_s, ctx.offsets,
                                  need_db=ctx.needs_input_grad[1])
        return (da if ctx.needs_input_grad[0] else None, db, None, None, None, None)


def _offsets_tuple(offsets):
    return tuple((int(o[0]), int(o[1])) for o in offsets)


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def fused_affinity_wmse_2d(e: torch.Tensor, t: torch.Tensor, w: torch.Tensor,
                           m: torch.Tensor, offsets):
    """(B, H, W, C) embedding, (B, K, H, W) target/weight/mask -> (S (K,),
    affs (B, K, H, W)). Takes any strided embedding view, e.g.
    ``emb_nchw.permute(0, 2, 3, 1)`` without a copy; the caller applies the
    criterion's normaliser."""
    if _device_type(e) == "cpu":
        return affinity_wmse_2d_plain(e, t, w, m, offsets)
    return _AffinityWMSE.apply(e, t, w, m, _offsets_tuple(offsets))


def fused_cross_affinity_wmse_2d(a: torch.Tensor, b: torch.Tensor,
                                 t: torch.Tensor, w: torch.Tensor,
                                 m: torch.Tensor, offsets):
    """Cross-view (student a, teacher b) variant of
    :func:`fused_affinity_wmse_2d`; the backward gives da, and db where b
    requires grad."""
    if _device_type(a) == "cpu":
        return cross_affinity_wmse_2d_plain(a, b, t, w, m, offsets)
    return _CrossAffinityWMSE.apply(a, b, t, w, m, _offsets_tuple(offsets))
