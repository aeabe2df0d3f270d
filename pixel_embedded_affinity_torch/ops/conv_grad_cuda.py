"""The float32 backward of the 2D models' stride-1 1x1 and 3x3 SAME
convolutions, the same bits on every run: the Hopper kernels of
``csrc/conv_grad.cu`` and their wrappers.

* :func:`conv_wgrad` (CWg) is the weight gradient dW = sum over the batch
  and the pixels of dy (x) x, a split-K implicit GEMM whose splits' partial
  tiles a second pass adds in split order;
* :func:`conv_dgrad` (CXg) is the input gradient, the conv of dy with the
  flipped, transposed weights (W^T dy for 1x1), an implicit GEMM whose
  reduction stays inside a block.

Every tensor is NCHW (the models' layout, so nothing is permuted); the
weights are (Cout, Cin, k, k). On a CUDA tensor each wrapper launches its
kernel (float32 only; built with nvcc at first use, see
:mod:`..cuda_build`); on a CPU tensor it runs its plain version,
:func:`conv_wgrad_plain` or :func:`conv_dgrad_plain`, PyTorch's
``aten.convolution_backward`` in the inputs' dtype (float32 or float64).
No TPU kernel corresponds: the JAX package leaves the conv backward to
XLA, whose float32 backward is deterministic, where cuDNN's default float32
weight and input gradients on the card are not (``tools/wgrad_determinism.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .launch_count import counted

SOURCE = "conv_grad.cu"
KERNEL_SIZES = (1, 3)


def _backward(dy, x, w, mask):
    k = w.shape[-1]
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1, mask)


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, weight_shape) -> torch.Tensor:
    """CWg's function in plain PyTorch: the weight gradient of a stride-1
    SAME conv with weights of ``weight_shape`` (Cout, Cin, k, k), from its
    input ``x`` (B, Cin, H, W) and output gradient ``dy`` (B, Cout, H, W),
    in their dtype."""
    w = x.new_empty(weight_shape)
    return _backward(dy, x, w, [False, True, False])[1]


def conv_dgrad_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CXg's function in plain PyTorch: the input gradient (B, Cin, H, W)
    of a stride-1 SAME conv with weights ``w`` (Cout, Cin, k, k) for the
    output gradient ``dy`` (B, Cout, H, W), in their dtype."""
    b, _, h, wd = dy.shape
    x = dy.new_empty((b, w.shape[1], h, wd))
    return _backward(dy, x, w, [True, False, False])[0]


_I, _P = ctypes.c_int, ctypes.c_void_p
_INTERFACE = {  # conv_grad.cu's C functions: (restype, argtypes)
    "conv_wgrad_wgmma": (_I, [_I] * 5),
    "conv_wgrad_splits": (_I, [_I] * 6),
    "conv_wgrad_workspace": (ctypes.c_int64, [_I] * 7),
    "conv_wgrad": (_I, [_P] * 4 + [_I] * 7 + [_P]),
    "conv_dgrad_workspace": (ctypes.c_int64, [_I] * 6),
    "conv_dgrad": (_I, [_P] * 4 + [_I] * 6 + [_P]),
}


def load(path: str | None = None) -> ctypes.CDLL:
    """``conv_grad.cu``'s library with its C functions declared: the
    package's build (built at first use), or another build of it at
    ``path`` (a tool timing two builds), each function it has."""
    from .. import cuda_build

    lib = cuda_build.load(SOURCE) if path is None else ctypes.CDLL(path)
    if lib.conv_wgrad.argtypes is None:
        for name, (restype, argtypes) in _INTERFACE.items():
            if hasattr(lib, name):
                getattr(lib, name).restype = restype
                getattr(lib, name).argtypes = argtypes
    return lib


_OTHER = None  # another build in the package's place (use_library)


def use_library(lib=None) -> None:
    """Run the wrappers on ``lib``, another build of ``conv_grad.cu`` with
    this C interface (from :func:`load`, or an object with its functions),
    or on the package's own build again (None): a tool's A/B of two builds
    through the same training step."""
    global _OTHER
    _OTHER = lib
    for f in (wgrad_splits, wgrad_workspace, dgrad_workspace):
        f.cache_clear()


def _lib():
    return _OTHER if _OTHER is not None else load()


def _check(name: str, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device}, expected one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


@functools.lru_cache(maxsize=256)
def wgrad_splits(b: int, cin: int, cout: int, h: int, w: int, k: int) -> int:
    """CWg's number of K splits for a shape (the kernel's own rule: shape
    only, never the card)."""
    return _lib().conv_wgrad_splits(b, cin, cout, h, w, k)


@functools.lru_cache(maxsize=256)
def wgrad_workspace(b: int, cin: int, cout: int, h: int, w: int, k: int) -> int:
    """CWg's workspace in floats for a shape: its splits' partial tiles and,
    on the wgmma path, dy's tf32 remainders."""
    return _lib().conv_wgrad_workspace(b, cin, cout, h, w, k, wgrad_splits(b, cin, cout, h, w, k))


@functools.lru_cache(maxsize=256)
def dgrad_workspace(b: int, cin: int, cout: int, h: int, w: int, k: int) -> int:
    """CXg's workspace in floats for a shape: the weights laid out as
    [tap][ci][co] with their tf32 remainders (the wgmma path), or 0."""
    return _lib().conv_dgrad_workspace(b, cin, cout, h, w, k)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (TMA's base address), copied
    where it is not, so a shape always takes one path."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on(device: torch.device, launch):
    """launch() with ``device`` current (a training step's tensors are on
    the current device already, and entering it costs host time a conv)."""
    if device.index == torch.cuda.current_device():
        return launch()
    with torch.cuda.device(device):
        return launch()


def conv_wgrad(x: torch.Tensor, dy: torch.Tensor, weight_shape) -> torch.Tensor:
    """The weight gradient (Cout, Cin, k, k) of a stride-1 SAME conv (k = 1
    or 3) from its input ``x`` (B, Cin, H, W) and output gradient ``dy``
    (B, Cout, H, W): the kernel on CUDA tensors (float32), the plain version
    on CPU ones. ``conv_wgrad.launches`` counts the kernel's launches."""
    cout, cin, k, k2 = weight_shape
    if k != k2 or k not in KERNEL_SIZES:
        raise ValueError(f"weights {tuple(weight_shape)}: 1x1 or 3x3 only")
    b, c, h, w = x.shape
    if c != cin or dy.shape != (b, cout, h, w):
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}, weights "
                         f"{tuple(weight_shape)} do not fit a stride-1 SAME conv")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return conv_wgrad_plain(x, dy, weight_shape)
    _check("conv_wgrad", x, dy)
    x, dy = _aligned(x), _aligned(dy)
    out = torch.empty(tuple(weight_shape), dtype=torch.float32, device=x.device)
    splits = wgrad_splits(b, cin, cout, h, w, k)
    work = torch.empty(wgrad_workspace(b, cin, cout, h, w, k), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _on(x.device, lambda: _lib().conv_wgrad(
        x.data_ptr(), dy.data_ptr(), out.data_ptr(), work.data_ptr(), b, cin, cout, h, w, k,
        splits, stream))
    if err != 0:
        raise RuntimeError(f"conv_wgrad launch failed: cudaError {err}")
    conv_wgrad.launches += 1
    return out


def conv_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient (B, Cin, H, W) of a stride-1 SAME conv with
    weights ``w`` (Cout, Cin, k, k), k = 1 or 3, for the output gradient
    ``dy`` (B, Cout, H, W): the kernel on CUDA tensors (float32), the plain
    version on CPU ones. ``conv_dgrad.launches`` counts the kernel's
    launches."""
    cout, cin, k, k2 = w.shape
    if k != k2 or k not in KERNEL_SIZES:
        raise ValueError(f"weights {tuple(w.shape)}: 1x1 or 3x3 only")
    if dy.dim() != 4 or dy.shape[1] != cout:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit weights {tuple(w.shape)}")
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return conv_dgrad_plain(dy, w)
    _check("conv_dgrad", dy, w)
    b, _, h, wd = dy.shape
    dy, w = _aligned(dy), w.contiguous()
    out = torch.empty((b, cin, h, wd), dtype=torch.float32, device=dy.device)
    work = torch.empty(max(dgrad_workspace(b, cin, cout, h, wd, k), 1), dtype=torch.float32,
                       device=dy.device)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    err = _on(dy.device, lambda: _lib().conv_dgrad(
        dy.data_ptr(), w.data_ptr(), out.data_ptr(), work.data_ptr(), b, cin, cout, h, wd, k,
        stream))
    if err != 0:
        raise RuntimeError(f"conv_dgrad launch failed: cudaError {err}")
    conv_dgrad.launches += 1
    return out


counted(conv_wgrad, conv_dgrad)
