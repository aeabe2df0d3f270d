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
(B, H, W, 4 c2) in x's dtype, accumulated in float32. On a CPU tensor it
runs :func:`fused_s2d_block_plain` (the parity form, as JAX computes it).
On a CUDA tensor it launches the kernel (float32 or bfloat16; c1 = cp = c2
in 16, 32, 64), which computes the block at direct resolution: the parity
taps are gathers of 3x3 taps, :func:`direct_taps` recovers those and
raises ``ValueError`` where the parity taps are not of that structure, and
the kernel reads and writes the s2d tensors through :func:`s2d_address`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import float32_convs
from .s2d import fuse_parity_groups, s2d_conv2x2_slices, s2d_conv2x2_weights
from .launch_count import counted

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


def s2d_address(y, x, c, k: int):
    """The s2d element (g, u, channel) that holds pixel (y, x), channel c of
    the direct image (B, 2H, 2W, k) of an s2d tensor (B, H, W, 4k), channel
    order (py, px, c): X[b, 2g + py, 2u + px, c] = x[b, g, u, (2 py + px) k
    + c]. The map ``csrc/s2d_block.cu`` reads and writes through (integer
    tensors or ints)."""
    return y >> 1, x >> 1, (2 * (y & 1) + (x & 1)) * k + c


# Per axis, the 2x2 parity taps are K_q[b, p] = w[q + 2b + p - 1] (see
# .s2d._tap2x2): direct tap i appears at the (q, b, p) with q + 2b + p = i + 1,
# twice per axis, four times per 2D tap; (q, b, p) = (0, 0, 0) and (1, 1, 1)
# are structural zeros.
_COPIES = [[(q, b, p) for q in (0, 1) for b in (0, 1) for p in (0, 1) if q + 2 * b + p == i + 1]
           for i in range(3)]


class DirectTaps(NamedTuple):
    """K8's direct-form weights: per input part (3, 3, Kp, 2c), output
    channels [conv1 | project]; conv2's (3, 3, c, c); the shifts h1, hp,
    h2 (c,) in float32."""
    w1p: tuple
    w2: torch.Tensor
    h1: torch.Tensor
    hp: torch.Tensor
    h2: torch.Tensor


def _direct_from_parity(k: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """The (3, 3, K, n) direct kernel whose 2x2 parity form (2, 2, 4K, 4n),
    input channels (py, px, ci), output (qy, qx, co), is ``k``; raises
    ValueError where ``k`` is not of that structure (a structural zero that
    is non-zero, or four copies of one tap that differ)."""
    if k.dim() != 4 or k.shape[:2] != (2, 2) or k.shape[2] % 4 or k.shape[3] != 4 * n:
        raise ValueError(f"{what}: parity taps must be (2, 2, 4K, {4 * n}), got {tuple(k.shape)}")
    cin = k.shape[2] // 4
    # [by, bx, py, px, qy, qx, ci, co]
    k8 = k.reshape(2, 2, 2, 2, cin, 2, 2, n).permute(0, 1, 2, 3, 5, 6, 4, 7)
    idx = torch.tensor(_COPIES, device=k.device)          # (tap, copy, (q, b, p))
    qy, by, py = (idx[:, None, :, None, j] for j in range(3))  # (3, 1, 2, 1)
    qx, bx, px = (idx[None, :, None, :, j] for j in range(3))  # (1, 3, 1, 2)
    copies = k8[by, bx, py, px, qy, qx]                    # (3, 3, 2, 2, ci, co)
    w = copies[:, :, 0, 0]
    zero = torch.ones((2,) * 6, dtype=torch.bool, device=k.device)
    zero[by, bx, py, px, qy, qx] = False
    if not bool((copies == w[:, :, None, None]).all()):
        raise ValueError(f"{what}: the four parity copies of a 3x3 tap differ")
    if bool(k8[zero].any()):
        raise ValueError(f"{what}: a structural zero of the parity taps is non-zero")
    return w


def direct_taps(k1ps, h1p, k2, h2, c1: int, cp: int, c2: int) -> DirectTaps:
    """Invert :func:`block_taps`: the direct 3x3 taps of K8's parity-form
    inputs, exact (a gather). Raises ValueError where the parity taps or
    the shifts (four copies each) are not of that structure."""
    k1ps = k1ps if isinstance(k1ps, (tuple, list)) else (k1ps,)
    g1 = c1 + cp
    w1p = tuple(_direct_from_parity(k, g1, "k1p").contiguous() for k in k1ps)
    w2 = _direct_from_parity(k2, c2, "k2").contiguous()
    h1p4, h24 = h1p.reshape(4, g1), h2.reshape(4, c2)
    if not bool((h1p4 == h1p4[:1]).all() and (h24 == h24[:1]).all()):
        raise ValueError("h1p and h2 must be four copies of the direct shifts")
    return DirectTaps(w1p, w2, h1p4[0, :c1].float(), h1p4[0, c1:].float(), h24[0].float())


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
                       + [ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def _check(xs, k1ps, h1p, k2, h2, c1, cp, c2):
    if len(xs) not in (1, 2) or len(k1ps) != len(xs):
        raise ValueError(f"one or two input parts with their taps, got {len(xs)}, {len(k1ps)}")
    x0 = xs[0]
    if x0.dtype not in _DTYPES:
        raise TypeError(f"dtype {x0.dtype} not supported (float32, bfloat16)")
    if c1 not in SUPPORTED_C or not c1 == cp == c2:
        raise ValueError(f"(c1, cp, c2) = ({c1}, {cp}, {c2}): the kernel takes c1, c2 in "
                         f"{SUPPORTED_C} with c1 == cp == c2")
    g1 = c1 + cp
    for x, k in zip(xs, k1ps):
        if (x.device != x0.device or x.dtype != x0.dtype or x.dim() != 4
                or x.shape[:3] != x0.shape[:3] or not x.is_contiguous() or x.shape[3] % 4):
            raise ValueError(f"the parts must be contiguous (B, H, W, 4K) tensors of one "
                             f"device, dtype, B, H, W; got {tuple(x.shape)} {x.dtype} "
                             f"strides {x.stride()}")
        if tuple(k.shape) != (2, 2, x.shape[3], 4 * g1):
            raise ValueError(f"k1p must be (2, 2, {x.shape[3]}, {4 * g1}), got {tuple(k.shape)}")
    if tuple(k2.shape) != (2, 2, 4 * c1, 4 * c2):
        raise ValueError(f"k2 must be (2, 2, {4 * c1}, {4 * c2}), got {tuple(k2.shape)}")
    if tuple(h1p.shape) != (4 * g1,) or tuple(h2.shape) != (4 * c2,):
        raise ValueError(f"h1p, h2 must be ({4 * g1},), ({4 * c2},), got "
                         f"{tuple(h1p.shape)}, {tuple(h2.shape)}")


def _launch(xs, d: DirectTaps, c: int) -> torch.Tensor:
    """The kernel on the CUDA parts ``xs`` with the direct taps ``d``."""
    x0 = xs[0]
    dt, dev = x0.dtype, x0.device
    for x, w in zip(xs, d.w1p):
        if tuple(w.shape) != (3, 3, x.shape[3] // 4, 2 * c):
            raise ValueError(f"direct w1p must be (3, 3, {x.shape[3] // 4}, {2 * c}), "
                             f"got {tuple(w.shape)}")
    if tuple(d.w2.shape) != (3, 3, c, c):
        raise ValueError(f"direct w2 must be (3, 3, {c}, {c}), got {tuple(d.w2.shape)}")
    ws = [w.to(device=dev, dtype=dt).contiguous() for w in d.w1p]
    w2 = d.w2.to(device=dev, dtype=dt).contiguous()
    h1, hp, h2 = (h.to(device=dev, dtype=torch.float32).contiguous() for h in (d.h1, d.hp, d.h2))
    b, h, w, _ = x0.shape
    out = torch.empty((b, h, w, 4 * c), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    x1, w1 = (xs[1], ws[1]) if len(xs) == 2 else (x0, ws[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().s2d_block_fwd(
            x0.data_ptr(), ws[0].data_ptr(), x0.shape[3] // 4,
            x1.data_ptr(), w1.data_ptr(), x1.shape[3] // 4, len(xs),
            w2.data_ptr(), h1.data_ptr(), hp.data_ptr(), h2.data_ptr(), out.data_ptr(),
            _DTYPES[dt], b, h, w, c, stream)
    if err != 0:
        raise RuntimeError(f"s2d_block_fwd launch failed: cudaError {err}")
    return out


def fused_s2d_block(xs, k1ps, h1p, k2, h2, c1: int, cp: int, c2: int, *,
                    direct: DirectTaps | None = None) -> torch.Tensor:
    """K8: ``xs`` (B, H, W, 4 Cin) or a tuple of two parts, ``k1ps`` the
    taps of each part; returns (B, H, W, 4 c2). On a CUDA tensor the
    kernel takes the direct taps: ``direct``, when the caller has them from
    :func:`direct_taps` once, else recovered from the parity taps here (a
    ValueError where they are not gathers of 3x3 taps).
    ``fused_s2d_block.launches`` counts its launches."""
    xs, k1ps = _parts(xs, k1ps)
    x0 = xs[0]
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    if x0.device.type == "cpu":
        return fused_s2d_block_plain(xs, k1ps, h1p, k2, h2, c1, cp, c2)
    _check(xs, k1ps, h1p, k2, h2, c1, cp, c2)
    if direct is None:
        direct = direct_taps(k1ps, h1p, k2, h2, c1, cp, c2)
    out = _launch(xs, direct, c1)
    fused_s2d_block.launches += 1
    return out


counted(fused_s2d_block)
