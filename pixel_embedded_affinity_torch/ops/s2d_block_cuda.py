"""One folded-BatchNorm residual block on the space-to-depth layout in one
launch: the Hopper kernel of ``csrc/s2d_block.cu`` (K8) and its wrapper.

``fused_s2d_block`` is the port of the TPU kernel
``pixel_embedded_affinity_tpu/ops/s2d_block_pallas.py::fused_s2d_block``:
relu(conv2(relu(conv1 x)) + project x) for an s2d tensor (B, H, W, 4 Cin)
or a tuple of two (a decoder's skip concat, never materialised), with
conv1 and the projection sharing the 2x2 parity taps ``k1ps``
(2, 2, 4 Cin_part, 4 (c1 + cp)), output groups (qy, qx, [c1 | cp]), conv2
the taps ``k2`` (2, 2, 4 c1, 4 c2) and the shifts ``h1p`` (4 (c1 + cp))
and ``h2`` (4 c2); see :mod:`.s2d` for the parity form. The output is
(B, H, W, 4 c2) in x's dtype, accumulated in float32. On a CUDA tensor it
launches the kernel (float32 or bfloat16; c1 and c2 in 16, 32, 64 and
cp == c2); on a CPU tensor it runs :func:`fused_s2d_block_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..device import float32_convs
from .s2d import fuse_parity_groups, s2d_conv2x2_slices, s2d_conv2x2_weights

SOURCE = "s2d_block.cu"
SUPPORTED_C = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _conv2x2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The 2x2 VALID conv of the 1-padded (B, H, W, K) tensor with HWIO
    k (2, 2, K, N), in float32: (B, H + 1, W + 1, N)."""
    with float32_convs():
        v = F.conv2d(x.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
                     padding=1)
    return v.permute(0, 2, 3, 1)


def block_taps(w1, wp, w2, h1, hp, h2, split_at: int | None = None):
    """K8's inputs from a residual block's folded direct weights, (3, 3,
    Cin, c) HWIO conv1, project and conv2 kernels and their (c,) shifts:
    (k1ps, h1p, k2, h2), k1ps a tuple of two parts split at input channel
    ``split_at`` when given."""
    def k1p(a, b):
        return fuse_parity_groups(s2d_conv2x2_weights(a), s2d_conv2x2_weights(b), 4)

    if split_at is None:
        k1ps = k1p(w1, wp)
    else:
        k1ps = (k1p(w1[:, :, :split_at], wp[:, :, :split_at]),
                k1p(w1[:, :, split_at:], wp[:, :, split_at:]))
    return k1ps, torch.cat([h1, hp]).repeat(4), s2d_conv2x2_weights(w2), h2.repeat(4)


def _parts(xs, k1ps):
    def tup(t):
        return tuple(t) if isinstance(t, (tuple, list)) else (t,)
    return tup(xs), tup(k1ps)


def fused_s2d_block_plain(xs, k1ps, h1p, k2, h2, c1: int, cp: int, c2: int) -> torch.Tensor:
    """K8's function in plain PyTorch, from the kernel's own inputs: V1 by
    2x2 convs of the padded parts plus h1p, y1 = relu(V1's conv1 parity
    slices) rounded to x's dtype (zero outside the image, as the padding of
    the second conv gives it), V2 = the 2x2 conv of y1 plus h2, and
    relu(V2's slices + V1's projection slices)."""
    xs, k1ps = _parts(xs, k1ps)
    dt = xs[0].dtype
    g1 = c1 + cp
    v1 = sum(_conv2x2(x, k.to(dt)) for x, k in zip(xs, k1ps)) + h1p.float()
    y1 = s2d_conv2x2_slices(v1.reshape(*v1.shape[:3], 4, g1)[..., :c1].reshape(
        *v1.shape[:3], 4 * c1), c1).relu().to(dt)
    v2 = _conv2x2(y1, k2.to(dt)) + h2.float()
    proj = s2d_conv2x2_slices(v1.reshape(*v1.shape[:3], 4, g1)[..., c1:].reshape(
        *v1.shape[:3], 4 * cp), cp)
    return (s2d_conv2x2_slices(v2, c2) + proj).relu().to(dt)


def _lib() -> ctypes.CDLL:
    from .. import cuda_build

    lib = cuda_build.load(SOURCE)
    fn = lib.s2d_block_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _check(xs, k1ps, h1p, k2, h2, c1, cp, c2):
    if len(xs) not in (1, 2) or len(k1ps) != len(xs):
        raise ValueError(f"one or two input parts with their taps, got {len(xs)}, {len(k1ps)}")
    x0 = xs[0]
    if x0.dtype not in _DTYPES:
        raise TypeError(f"dtype {x0.dtype} not supported (float32, bfloat16)")
    if c1 not in SUPPORTED_C or c2 not in SUPPORTED_C or cp != c2:
        raise ValueError(f"(c1, cp, c2) = ({c1}, {cp}, {c2}): the kernel takes c1, c2 in "
                         f"{SUPPORTED_C} and cp == c2")
    g1 = c1 + cp
    for x, k in zip(xs, k1ps):
        if (x.device != x0.device or x.dtype != x0.dtype or x.dim() != 4
                or x.shape[:3] != x0.shape[:3] or not x.is_contiguous()):
            raise ValueError(f"the parts must be contiguous (B, H, W, K) tensors of one "
                             f"device, dtype, B, H, W; got {tuple(x.shape)} {x.dtype} "
                             f"strides {x.stride()}")
        if tuple(k.shape) != (2, 2, x.shape[3], 4 * g1):
            raise ValueError(f"k1p must be (2, 2, {x.shape[3]}, {4 * g1}), got {tuple(k.shape)}")
    if tuple(k2.shape) != (2, 2, 4 * c1, 4 * c2):
        raise ValueError(f"k2 must be (2, 2, {4 * c1}, {4 * c2}), got {tuple(k2.shape)}")
    if tuple(h1p.shape) != (4 * g1,) or tuple(h2.shape) != (4 * c2,):
        raise ValueError(f"h1p, h2 must be ({4 * g1},), ({4 * c2},), got "
                         f"{tuple(h1p.shape)}, {tuple(h2.shape)}")


def fused_s2d_block(xs, k1ps, h1p, k2, h2, c1: int, cp: int, c2: int) -> torch.Tensor:
    """K8: ``xs`` (B, H, W, 4 Cin) or a tuple of two parts, ``k1ps`` the
    taps of each part; returns (B, H, W, 4 c2). ``fused_s2d_block.launches``
    counts its launches."""
    xs, k1ps = _parts(xs, k1ps)
    x0 = xs[0]
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    if x0.device.type == "cpu":
        return fused_s2d_block_plain(xs, k1ps, h1p, k2, h2, c1, cp, c2)
    _check(xs, k1ps, h1p, k2, h2, c1, cp, c2)
    dt, dev = x0.dtype, x0.device
    ks = [k.to(device=dev, dtype=dt).contiguous() for k in k1ps]
    k2 = k2.to(device=dev, dtype=dt).contiguous()
    h1p = h1p.to(device=dev, dtype=torch.float32).contiguous()
    h2 = h2.to(device=dev, dtype=torch.float32).contiguous()
    b, h, w, _ = x0.shape
    out = torch.empty((b, h, w, 4 * c2), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    x1, k1 = (xs[1], ks[1]) if len(xs) == 2 else (x0, ks[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().s2d_block_fwd(
            x0.data_ptr(), ks[0].data_ptr(), x0.shape[3],
            x1.data_ptr(), k1.data_ptr(), x1.shape[3], len(xs),
            k2.data_ptr(), h1p.data_ptr(), h2.data_ptr(), out.data_ptr(),
            _DTYPES[dt], b, h, w, c1, c2, stream)
    if err != 0:
        raise RuntimeError(f"s2d_block_fwd launch failed: cudaError {err}")
    fused_s2d_block.launches += 1
    return out


fused_s2d_block.launches = 0
