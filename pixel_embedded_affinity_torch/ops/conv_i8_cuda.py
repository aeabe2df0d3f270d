"""The int8 convolution and the activation quantizer of int8 serving: the
Hopper kernels of ``csrc/conv_i8.cu`` and their wrappers.

Neither has a TPU site: the JAX package computes both outside Pallas
(``ops/quant.py``: ``conv_i8`` is an XLA conv with an int32 accumulator,
``quantize_act`` a jnp expression), and no PyTorch call computes an int8
convolution on the card.

* :func:`conv_i8` (I8c): an NHWC int8 input, int8 weights, an int32
  accumulator, and float32 ``acc * out_scale[c] (+ shift[c])``. The weights
  are packed once (:func:`pack_weights_i8`) as (Cout, kh kw Cin), K
  contiguous, the tensor cores' B operand; an HWIO int8 kernel is packed
  at the call. The kernel reads both through TMA, which takes Cin a
  multiple of 16 and 16-byte aligned tensors: :func:`aligned_operands`
  gives other inputs zero channels in a scratch copy.
* :func:`quantize_act` (I8q): float32 or bfloat16 -> int8,
  ``clip(round(float(x) * (1 / scale)), -127, 127)``, half to even.

On a CUDA tensor each wrapper launches its kernel (built with nvcc at first
use, :mod:`..cuda_build`) and raises if the build or the launch fails; on a
CPU tensor it runs the plain version, :func:`conv_i8_plain` or
:func:`quantize_act_plain`. ``conv_i8.launches`` and
``quantize_act.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .launch_count import counted

SOURCE = "conv_i8.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class I8Weights(NamedTuple):
    """Packed int8 weights: ``packed`` (Cout, kh * kw * Cin), K order
    (dy, dx, ci)."""
    packed: torch.Tensor
    kh: int
    kw: int

    @property
    def cout(self) -> int:
        return self.packed.shape[0]

    @property
    def cin(self) -> int:
        return self.packed.shape[1] // (self.kh * self.kw)


def pack_weights_i8(w_q: torch.Tensor) -> I8Weights:
    """An HWIO (kh, kw, Cin, Cout) int8 kernel in the kernel's packed form."""
    if w_q.dtype != torch.int8 or w_q.dim() != 4:
        raise ValueError(f"expected an int8 (kh, kw, Cin, Cout) kernel, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    kh, kw, _, cout = w_q.shape
    return I8Weights(w_q.permute(3, 0, 1, 2).reshape(cout, -1).contiguous(), kh, kw)


def _weights(w) -> I8Weights:
    return w if isinstance(w, I8Weights) else pack_weights_i8(w)


def _check_padding(padding):
    padding = tuple(int(p) for p in padding)
    if len(padding) != 4 or min(padding) < 0:
        raise ValueError(f"padding must be (top, bottom, left, right) >= 0, got {padding}")
    return padding


def conv_i8_acc_plain(x_q: torch.Tensor, w, padding=(1, 1, 1, 1)) -> torch.Tensor:
    """The int32 accumulator (B, Ho, Wo, Cout) of the conv of the NHWC int8
    ``x_q`` with ``w`` (packed or HWIO int8), padded (top, bottom, left,
    right): ``F.conv2d`` in float64 on the int8 values, exact while
    127^2 kh kw Cin < 2^53."""
    w = _weights(w)
    pt, pb, pl, pr = _check_padding(padding)
    w4 = w.packed.reshape(w.cout, w.kh, w.kw, w.cin).permute(0, 3, 1, 2).double()
    x = F.pad(x_q.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    return F.conv2d(x, w4).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_i8_plain(x_q: torch.Tensor, w, out_scale: torch.Tensor, shift=None,
                  padding=(1, 1, 1, 1)) -> torch.Tensor:
    """I8c's function in plain PyTorch: the accumulator
    (:func:`conv_i8_acc_plain`) to float32, times ``out_scale``, plus
    ``shift``, in that order."""
    y = conv_i8_acc_plain(x_q, w, padding).float() * out_scale.float()
    return y + shift.float() if shift is not None else y


def quantize_act_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    """I8q's function in plain PyTorch."""
    return torch.round(x.float() * _inv(scale)).clamp_(-127, 127).to(torch.int8)


def _inv(scale: float) -> float:
    """1 / scale as the JAX package multiplies by it: the Python float's
    quotient rounded once to float32."""
    return float(np.float32(1.0 / float(scale)))


def aligned_operands(x_q: torch.Tensor, w: I8Weights):
    """``(x, packed)`` as the kernel takes them: Cin a multiple of 16 and
    both 16-byte aligned. Where ``x_q`` and ``w`` are not, they are copied
    into ``torch.empty`` scratch with zero channels appended to each pixel
    and to each tap's weights, which add nothing to the sums."""
    packed, cin = w.packed, w.cin
    pad = -cin % 16
    if not pad and x_q.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0:
        return x_q, packed
    x = torch.empty(x_q.shape[:-1] + (cin + pad,), dtype=torch.int8, device=x_q.device)
    x[..., :cin] = x_q
    x[..., cin:] = 0
    taps = w.kh * w.kw
    p = torch.empty((w.cout, taps, cin + pad), dtype=torch.int8, device=packed.device)
    p[..., :cin] = packed.reshape(w.cout, taps, cin)
    p[..., cin:] = 0
    return x, p.reshape(w.cout, -1)


PLAN_KEYS = ("S", "BN", "BM", "TW", "TH", "tiles", "grid", "stages", "smem_bytes")


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    if lib.conv_i8_fwd.argtypes is None:
        lib.conv_i8_fwd.restype = ctypes.c_int
        lib.conv_i8_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.quantize_i8.restype = ctypes.c_int
        lib.quantize_i8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
        lib.conv_i8_plan.restype = ctypes.c_int
        lib.conv_i8_plan.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p]
    return lib


def conv_plan(x_shape, w: I8Weights, padding=(1, 1, 1, 1), lib=None) -> dict:
    """The tiling I8c launches for an input of ``x_shape`` (B, H, W, Cin):
    k-block bytes S, the N tile BN, the M tile of BM pixels in a TW x TH
    box, the tiles, the persistent grid, the ring's stages and a block's
    shared memory (on the current CUDA device, or through ``lib``)."""
    b, h, wd, cin = x_shape
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = (lib or _lib()).conv_i8_plan(b, h, wd, cin + (-cin % 16), w.cout, w.kh, w.kw,
                                       *_check_padding(padding), out)
    if err != 0:
        raise ValueError(f"I8c takes no input {tuple(x_shape)} with {w.kh}x{w.kw} -> {w.cout}, "
                         f"padding {padding}: cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def _vec(v, n: int, like: torch.Tensor, name: str) -> torch.Tensor:
    v = torch.as_tensor(v, device=like.device).float().contiguous()
    if v.shape != (n,):
        raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
    return v


def _launch_conv(x_q, w: I8Weights, out_scale, shift, padding) -> torch.Tensor:
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or not x_q.is_contiguous():
        raise ValueError(f"x_q must be a contiguous int8 (B, H, W, Cin) tensor, got "
                         f"{x_q.dtype} {tuple(x_q.shape)} strides {x_q.stride()}")
    b, h, wd, cin = x_q.shape
    if w.cin != cin or w.packed.dtype != torch.int8:
        raise ValueError(f"weights of Cin {w.cin} ({w.packed.dtype}) for an input of Cin {cin}")
    pt, pb, pl, pr = _check_padding(padding)
    ho, wo = h + pt + pb - w.kh + 1, wd + pl + pr - w.kw + 1
    x, packed = aligned_operands(x_q, w._replace(packed=w.packed.to(x_q.device).contiguous()))
    scale = None if out_scale is None else _vec(out_scale, w.cout, x_q, "out_scale")
    shift = None if shift is None else _vec(shift, w.cout, x_q, "shift")
    out = torch.empty((b, ho, wo, w.cout), dtype=torch.float32 if scale is not None
                      else torch.int32, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    with torch.cuda.device(x_q.device):
        err = _lib().conv_i8_fwd(x.data_ptr(), packed.data_ptr(),
                                 None if scale is None else scale.data_ptr(),
                                 None if shift is None else shift.data_ptr(), out.data_ptr(),
                                 b, h, wd, x.shape[-1], w.cout, w.kh, w.kw, pt, pb, pl, pr,
                                 stream)
    if err != 0:
        raise RuntimeError(f"conv_i8_fwd launch failed: cudaError {err}")
    return out


def conv_i8(x_q: torch.Tensor, w, out_scale: torch.Tensor, shift=None,
            padding=(1, 1, 1, 1)) -> torch.Tensor:
    """I8c: NHWC int8 ``x_q`` (B, H, W, Cin) conv ``w`` (:class:`I8Weights`
    or an HWIO int8 kernel) with ``padding`` (top, bottom, left, right) ->
    float32 (B, Ho, Wo, Cout) ``acc * out_scale (+ shift)``."""
    w = _weights(w)
    if _on_cpu(x_q):
        return conv_i8_plain(x_q, w, out_scale, shift, padding)
    out = _launch_conv(x_q, w, out_scale, shift, padding)
    conv_i8.launches += 1
    return out


def conv_i8_acc(x_q: torch.Tensor, w, padding=(1, 1, 1, 1)) -> torch.Tensor:
    """I8c's int32 accumulator itself (a check of the kernel; the serving
    path calls :func:`conv_i8`). Counts no launch."""
    w = _weights(w)
    if _on_cpu(x_q):
        return conv_i8_acc_plain(x_q, w, padding)
    return _launch_conv(x_q, w, None, None, padding)


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """I8q: float32 or bfloat16 ``x`` -> int8 of its shape, with the static
    per-tensor ``scale`` (a float)."""
    if _on_cpu(x):
        return quantize_act_plain(x, scale)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().quantize_i8(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], _inv(scale),
                                 x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"quantize_i8 launch failed: cudaError {err}")
    quantize_act.launches += 1
    return out


counted(conv_i8, quantize_act)
