"""The x2 align-corners upsampling of the decoders with a deterministic
backward: the Hopper kernel of ``csrc/upsample_bwd.cu`` and its wrapper.

:class:`UpsampleAlignCorners` is a ``torch.autograd.Function`` whose forward
is PyTorch's ``F.interpolate`` (bilinear for NCHW, trilinear at scale
(1, 2, 2) for NCDHW, align_corners=True), so the forward is unchanged to
the bit. Its backward is the transpose of the separable 2-tap
interpolation, with the forward's own weights on the device
(:func:`forward_matrix`): on a CUDA tensor it launches the gather kernel of
``csrc/upsample_bwd.cu``, which sums each input element's outputs in a
fixed order (PyTorch's own backward adds with atomics, in an order that
changes from run to run); on a CPU tensor it runs
:func:`upsample_bwd_plain`, two interpolation-matrix products
``My^T g Mx``. No TPU kernel corresponds: XLA's backward of the JAX
package's resize is deterministic on the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

SOURCE = "upsample_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


@functools.lru_cache(maxsize=64)
def forward_matrix(n: int, axis: int, ndim: int, device: str, dtype=torch.float32) -> torch.Tensor:
    """(2n, n): entry [o, i] is the weight with which :func:`upsample_fwd`'s
    output o along ``axis`` (-2 for y, -1 for x) of an ``ndim``-D input
    reads input i, as the forward computes it on ``device`` in ``dtype``
    (the accumulation type: float32 for float32 and bfloat16 inputs). It is
    read off the forward itself, a one-hot input a channel: PyTorch's CUDA
    and CPU kernels round the align-corners source index differently at
    some sizes, so no one formula gives both."""
    probe = [1] * ndim
    probe[1], probe[axis] = n, n
    eye = torch.eye(n, dtype=dtype, device=device).reshape(probe)
    with torch.no_grad():
        y = upsample_fwd(eye)
    index = [0] * ndim
    index[1], index[axis] = slice(None), slice(None)
    return y[tuple(index)].t().contiguous()


@functools.lru_cache(maxsize=64)
def taps(n: int, axis: int, ndim: int, device: str, dtype=torch.float32) -> torch.Tensor:
    """(n, 5): [i, a] the weight with which output 2i - 2 + a reads input i
    (0 outside), the kernel's form of :func:`forward_matrix`; raises if the
    forward reads an input from farther away."""
    m = forward_matrix(n, axis, ndim, device, dtype)
    o = torch.arange(2 * n, device=m.device)[:, None]
    i = torch.arange(n, device=m.device)[None, :]
    if bool((m[(o - 2 * i).abs() > 2] != 0).any()):
        raise RuntimeError(f"the forward reads input rows from beyond 2i +- 2 at n={n}")
    rows = 2 * i.t() - 2 + torch.arange(5, device=m.device)[None, :]
    inside = (rows >= 0) & (rows < 2 * n)
    return torch.where(inside, m[rows.clamp(0, 2 * n - 1), i.t().expand_as(rows)], 0).contiguous()


def upsample_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the gradient of the x2
    upsampling of the last two axes for an output gradient ``g`` (..., 2H,
    2W), ``My^T g Mx`` with the forward's matrices on ``g``'s device, in
    float32 (float64 for float64) and returned in ``g``'s dtype."""
    oh, ow = g.shape[-2:]
    if oh % 2 or ow % 2:
        raise ValueError(f"output gradient {tuple(g.shape)}: the last two axes must be even")
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    dev, ndim = str(g.device), _forward_ndim(g)
    my = forward_matrix(oh // 2, -2, ndim, dev, acc)
    mx = forward_matrix(ow // 2, -1, ndim, dev, acc)
    return (my.t() @ g.to(acc) @ mx).to(g.dtype)


def _forward_ndim(g: torch.Tensor) -> int:
    """The rank of the forward whose weights ``g``'s backward takes: the
    trilinear (1, 2, 2) for NCDHW, else the bilinear."""
    return 5 if g.dim() == 5 else 4


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.upsample_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3)
    return lib


def upsample_bwd(g: torch.Tensor) -> torch.Tensor:
    """The gradient of the x2 upsampling for ``g`` (..., 2H, 2W): the kernel
    on a CUDA tensor (float32, bfloat16 or float64), the plain version on a
    CPU one. ``upsample_bwd.launches`` counts the kernel's launches."""
    if g.device.type == "cpu":
        return upsample_bwd_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"dtype {g.dtype} not supported (float32, bfloat16, float64)")
    oh, ow = g.shape[-2:]
    if oh % 2 or ow % 2:
        raise ValueError(f"output gradient {tuple(g.shape)}: the last two axes must be even")
    h, w = oh // 2, ow // 2
    g = g.contiguous()
    out = torch.empty(g.shape[:-2] + (h, w), dtype=g.dtype, device=g.device)
    planes = out.numel() // max(h * w, 1)
    if out.numel() == 0:
        return out
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    ty = taps(h, -2, _forward_ndim(g), str(g.device), acc)
    tx = taps(w, -1, _forward_ndim(g), str(g.device), acc)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = _lib().upsample_bwd(g.data_ptr(), out.data_ptr(), _DTYPES[g.dtype],
                                  planes, h, w, ty.data_ptr(), tx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"upsample_bwd launch failed: cudaError {err}")
    upsample_bwd.launches += 1
    return out


upsample_bwd.launches = 0


def upsample_fwd(x: torch.Tensor) -> torch.Tensor:
    """PyTorch's x2 align-corners upsampling of y and x: bilinear for NCHW,
    trilinear at scale (1, 2, 2) for NCDHW (z copied as is)."""
    if x.dim() == 4:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    if x.dim() == 5:
        return F.interpolate(x, scale_factor=(1, 2, 2), mode="trilinear", align_corners=True)
    raise ValueError(f"expected NCHW or NCDHW, got shape {tuple(x.shape)}")


class UpsampleAlignCorners(torch.autograd.Function):
    """:func:`upsample_fwd` with the deterministic backward :func:`upsample_bwd`."""

    @staticmethod
    def forward(ctx, x):
        return upsample_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return upsample_bwd(g)
