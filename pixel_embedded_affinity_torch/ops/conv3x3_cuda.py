"""SAME stride-1 3x3 convolution with a scale/shift epilogue and an
optional ReLU, NHWC with HWIO (3, 3, Cin, Cout) weights: the Hopper kernel
of ``csrc/conv3x3.cu`` and its wrappers.

Three TPU kernels compute this one function, and each has its wrapper and
launch counter here:

* ``conv3x3_fused`` (K7) is ``ops/conv3x3_pallas.py::conv3x3_fused``;
* ``conv3x3_blocked`` (K9a) is ``ops/conv3x3_blocked.py::conv3x3_blocked``,
  whose 128-lane blocked-pixel layout is internal to the TPU kernel;
* ``conv3x3_blocked_flat`` (K9b) is one step of
  ``conv3x3_blocked_chain``: a C -> C conv on a zero-bordered NHWC canvas
  (the TPU's "blocked stream") that moves the image from (oy, ox) to
  (oy - 1, ox - 1) and leaves every canvas element outside it exactly 0,
  so k steps chain with one ``blocked_ingest`` (a pad) before and one
  ``blocked_egress`` (a slice) after. The TPU's block-banded weight packing
  (``pack_weights_blocked``) serves its 128-lane matrix unit and has no
  counterpart here.

y = conv(x) * scale + shift in float32, then ReLU if asked, stored in x's
dtype (float32 or bfloat16); the weights are taken in x's dtype, as the JAX
kernels take them. On a CUDA tensor each wrapper launches the kernel, an
implicit GEMM on the tensor cores (3xTF32 for float32, bf16 products for
bfloat16; built with nvcc at first use, see :mod:`..cuda_build`); on a CPU
tensor it runs the plain version, :func:`conv3x3_plain` or
:func:`conv3x3_canvas_plain`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..device import float32_convs
from .launch_count import counted

SOURCE = "conv3x3.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _epilogue(y, scale, shift, relu: bool):
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    return y.relu() if relu else y


def _conv_f32(x_nhwc: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """F.conv2d in full float32 of x (B, H, W, Cin) with HWIO w (in x's
    dtype, then float32); returns (B, H', W', Cout)."""
    with float32_convs():
        y = F.conv2d(x_nhwc.float().permute(0, 3, 1, 2),
                     w.to(x_nhwc.dtype).float().permute(3, 2, 0, 1), padding=padding)
    return y.permute(0, 2, 3, 1)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None,
                  relu: bool = False) -> torch.Tensor:
    """K7's and K9a's function in plain PyTorch."""
    return _epilogue(_conv_f32(x, w, 1), scale, shift, relu).to(x.dtype)


def conv3x3_canvas_plain(canvas: torch.Tensor, w: torch.Tensor, oy: int, ox: int,
                         h: int, wd: int, scale=None, shift=None,
                         relu: bool = False) -> torch.Tensor:
    """K9b's function in plain PyTorch: the conv of the canvas centred one
    pixel down and right, the epilogue, and exact zeros outside the image's
    new place [oy - 1, oy - 1 + h) x [ox - 1, ox - 1 + wd)."""
    y = _conv_f32(F.pad(canvas, (0, 0, 0, 2, 0, 2)), w, 0)
    y = _epilogue(y, scale, shift, relu)
    keep = torch.zeros(canvas.shape[1:3], dtype=torch.bool, device=canvas.device)
    keep[oy - 1:oy - 1 + h, ox - 1:ox - 1 + wd] = True
    return torch.where(keep[None, :, :, None], y, torch.zeros((), device=y.device)).to(canvas.dtype)


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.conv3x3_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _vec(v, n: int, fill: float, like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=like.device)
    v = torch.as_tensor(v, device=like.device).float().contiguous()
    if v.shape != (n,):
        raise ValueError(f"scale/shift must be ({n},), got {tuple(v.shape)}")
    return v


def _launch(x: torch.Tensor, w: torch.Tensor, scale, shift, relu: bool,
            off: int, rect) -> torch.Tensor:
    """The kernel on a CUDA (B, H, W, Cin) tensor; ``off`` 1 for SAME, 0 for
    the canvas mode; ``rect`` (r0, r1, c0, c1) the output kept."""
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, H, W, Cin) tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    w = w.to(device=x.device, dtype=x.dtype).contiguous()
    scale = _vec(scale, cout, 1.0, x)
    shift = _vec(shift, cout, 0.0, x)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().conv3x3_fwd(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                 shift.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                                 b, h, wd, cin, cout, off, *rect, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_fwd launch failed: cudaError {err}")
    return out


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None,
                  relu: bool = False) -> torch.Tensor:
    """K7: x (B, H, W, Cin), w (3, 3, Cin, Cout) -> (B, H, W, Cout);
    scale/shift (Cout,) fold bias and BatchNorm. ``conv3x3_fused.launches``
    counts its launches."""
    if _on_cpu(x):
        return conv3x3_plain(x, w, scale, shift, relu)
    out = _launch(x, w, scale, shift, relu, 1, (0, x.shape[1], 0, x.shape[2]))
    conv3x3_fused.launches += 1
    return out


def conv3x3_blocked(x: torch.Tensor, w: torch.Tensor, scale=None, shift=None,
                    relu: bool = False) -> torch.Tensor:
    """K9a: K7's function (the TPU kernel's blocked-pixel layout is its
    own). ``conv3x3_blocked.launches`` counts its launches."""
    if _on_cpu(x):
        return conv3x3_plain(x, w, scale, shift, relu)
    out = _launch(x, w, scale, shift, relu, 1, (0, x.shape[1], 0, x.shape[2]))
    conv3x3_blocked.launches += 1
    return out


@dataclass(frozen=True)
class CanvasGeom:
    """A zero-bordered NHWC canvas (B, height, width, c) that holds an
    h x w image: the port's form of the TPU's padded blocked pixel stream
    (``BlockedGeom``). The image's place (oy, ox) goes with each call."""
    b: int
    h: int
    w: int
    c: int
    height: int
    width: int


def blocked_ingest(x: torch.Tensor, top: int, left: int) -> tuple[torch.Tensor, CanvasGeom]:
    """(B, H, W, C) -> a zero canvas (B, top + H + 1, left + W + 1, C) with
    the image at rows [top, top + H) x cols [left, left + W)."""
    b, h, wd, c = x.shape
    if top < 0 or left < 0:
        raise ValueError(f"the image's place ({top}, {left}) must be >= 0")
    canvas = F.pad(x, (0, 0, left, 1, top, 1))
    return canvas, CanvasGeom(b, h, wd, c, top + h + 1, left + wd + 1)


def blocked_egress(canvas: torch.Tensor, g: CanvasGeom, oy: int, ox: int) -> torch.Tensor:
    """The (B, h, w, c) image at (oy, ox) of the canvas."""
    return canvas[:, oy:oy + g.h, ox:ox + g.w, :]


def conv3x3_blocked_flat(canvas: torch.Tensor, w: torch.Tensor, g: CanvasGeom,
                         oy: int, ox: int, scale=None, shift=None,
                         relu: bool = False) -> torch.Tensor:
    """K9b: one C -> C conv (+ scale/shift, ReLU) of the image at (oy, ox)
    of the canvas; returns a canvas of the same shape with the image at
    (oy - 1, ox - 1) and exact zeros elsewhere.
    ``conv3x3_blocked_flat.launches`` counts its launches."""
    if tuple(canvas.shape) != (g.b, g.height, g.width, g.c):
        raise ValueError(f"canvas {tuple(canvas.shape)} does not match {g}")
    if tuple(w.shape) != (3, 3, g.c, g.c):
        raise ValueError(f"the chain form needs C -> C convs, got {tuple(w.shape)} for C={g.c}")
    if oy < 1 or ox < 1:
        raise ValueError("the image must keep a zero border to shift into")
    if _on_cpu(canvas):
        return conv3x3_canvas_plain(canvas, w, oy, ox, g.h, g.w, scale, shift, relu)
    out = _launch(canvas, w, scale, shift, relu, 0,
                  (oy - 1, oy - 1 + g.h, ox - 1, ox - 1 + g.w))
    conv3x3_blocked_flat.launches += 1
    return out


def conv3x3_blocked_chain(x: torch.Tensor, weights, scales=None, shifts=None,
                          relu: bool = True) -> torch.Tensor:
    """k chained SAME 3x3 C -> C convs, each with scale/shift and an
    optional ReLU: one ingest, k canvas launches, one egress."""
    k = len(weights)
    scales = scales if scales is not None else [None] * k
    shifts = shifts if shifts is not None else [None] * k
    canvas, g = blocked_ingest(x.contiguous(), top=k, left=k)
    oy = ox = k
    for w, sc, sh in zip(weights, scales, shifts):
        canvas = conv3x3_blocked_flat(canvas, w, g, oy, ox, sc, sh, relu)
        oy, ox = oy - 1, ox - 1
    return blocked_egress(canvas, g, oy, ox)


counted(conv3x3_fused, conv3x3_blocked, conv3x3_blocked_flat)
