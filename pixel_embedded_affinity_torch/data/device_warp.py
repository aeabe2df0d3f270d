"""Geometric warps on the device with cv2's and scipy's sampling
conventions: the JAX package's ``data/device_warp.py`` in PyTorch.

The BBBC device sampler (:mod:`.device_data`) warps with these; the host
chains they stand for warp with ``cv2.remap``, ``cv2.warpAffine`` and
``cv2.resize`` and smooth noise with ``scipy.ndimage.gaussian_filter``.
Each function takes its parameters explicitly (angles, factors, fields);
the random draws live in the sampler. Images are (H, W) tensors, or
(..., H, W) stacks that one map warps alike (the AC3/AC4 sampler's
volumes); coordinates are (h, w) float32 tensors on the image's device.

Conventions reproduced:
- scipy's gaussian_filter: truncate 4, radius int(truncate * sigma + 0.5),
  'reflect' boundary (numpy's 'symmetric': the edge repeated);
- cv2.remap's BORDER_REFLECT: i < 0 -> -i - 1, i >= n -> 2n - 1 - i (the
  edge repeated), applied to the integer neighbour indices;
- cv2.warpAffine(M): dst(x, y) = src(M^-1 (x, y, 1)); INTER_LINEAR for
  images, INTER_NEAREST (rounding) for labels; BORDER_CONSTANT fills 0;
- cv2.resize: src = (dst + 0.5) / f - 0.5, clamped to the valid range.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import float32_convs


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's pad mode 'symmetric' (the edge repeated) for any i."""
    m = torch.remainder(i, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def gaussian_blur2d(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur of a (H, W) float32 map, scipy's 'reflect'
    boundary: per axis, the map padded by gathering, then one correlation
    with the kernel over all rows (in full float32 on a card)."""
    k = torch.as_tensor(gaussian_kernel1d(sigma, truncate))
    r = (k.numel() - 1) // 2
    weight = k.to(x.device).reshape(1, 1, -1)
    for _ in range(2):  # along x, then along y through the transpose
        n = x.shape[1]
        xp = x[:, _symmetric_index(torch.arange(-r, n + r, device=x.device), n)]
        with float32_convs():
            x = F.conv1d(xp[:, None], weight)[:, 0].t()
    return x


def reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """cv2's BORDER_REFLECT (edge repeated) for integer indices, one fold:
    i < 0 -> -i - 1; i >= n -> 2n - 1 - i; then clamped (the fields here
    never reach past one fold)."""
    i = torch.where(i < 0, -i - 1, i)
    i = torch.where(i >= n, 2 * n - 1 - i, i)
    return torch.clamp(i, 0, n - 1)


def reflect101_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """np.pad's 'reflect' (edge not repeated, cv2's BORDER_REFLECT_101) for
    integer indices, one fold: i < 0 -> -i; i >= n -> 2n - 2 - i; then
    clamped."""
    i = torch.where(i < 0, -i, i)
    i = torch.where(i >= n, 2 * n - 2 - i, i)
    return torch.clamp(i, 0, n - 1)


def _gather2d(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (..., H, W) at integer index maps yi, xi (h, w): (..., h, w)."""
    flat = img.reshape(*img.shape[:-2], -1)
    return flat[..., yi * img.shape[-1] + xi]


def remap_bilinear(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
                   border: str = "reflect") -> torch.Tensor:
    """cv2.remap(INTER_LINEAR): img sampled at the float coordinates (my,
    mx). ``border``: 'reflect' (BORDER_REFLECT) or 'constant' (each tap
    outside the image counts 0)."""
    h, w = img.shape[-2:]
    x0 = torch.floor(mx).to(torch.int64)
    y0 = torch.floor(my).to(torch.int64)
    fx = mx - x0.to(torch.float32)
    fy = my - y0.to(torch.float32)
    w00 = (1 - fy) * (1 - fx)
    w01 = (1 - fy) * fx
    w10 = fy * (1 - fx)
    w11 = fy * fx
    if border == "reflect":
        xi0, xi1 = reflect_index(x0, w), reflect_index(x0 + 1, w)
        yi0, yi1 = reflect_index(y0, h), reflect_index(y0 + 1, h)
    elif border == "constant":
        # gather clamped, the tap's weight zeroed
        vx0, vx1 = ((x0 >= 0) & (x0 < w)).to(img.dtype), ((x0 >= -1) & (x0 < w - 1)).to(img.dtype)
        vy0, vy1 = ((y0 >= 0) & (y0 < h)).to(img.dtype), ((y0 >= -1) & (y0 < h - 1)).to(img.dtype)
        xi0, xi1 = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
        yi0, yi1 = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
        w00, w01 = w00 * vy0 * vx0, w01 * vy0 * vx1
        w10, w11 = w10 * vy1 * vx0, w11 * vy1 * vx1
    else:
        raise ValueError(f"border must be 'reflect' or 'constant', got {border!r}")
    return (_gather2d(img, yi0, xi0) * w00 + _gather2d(img, yi0, xi1) * w01
            + _gather2d(img, yi1, xi0) * w10 + _gather2d(img, yi1, xi1) * w11)


def remap_nearest(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
                  border: str = "reflect") -> torch.Tensor:
    """cv2.remap(INTER_NEAREST): the source pixel nearest (my, mx)."""
    h, w = img.shape[-2:]
    xi = torch.floor(mx + 0.5).to(torch.int64)
    yi = torch.floor(my + 0.5).to(torch.int64)
    if border == "reflect":
        return _gather2d(img, reflect_index(yi, h), reflect_index(xi, w))
    if border != "constant":
        raise ValueError(f"border must be 'reflect' or 'constant', got {border!r}")
    out = _gather2d(img, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1))
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return torch.where(inside, out, torch.zeros_like(out))


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(yy, xx) float32 pixel coordinates (h, w)."""
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def rotation_coords(angle_deg, h: int, w: int, center=None, device=None):
    """(mx, my) of cv2.warpAffine(cv2.getRotationMatrix2D(center, angle,
    1)): dst (y, x) samples src at the rotation by -angle about ``center``
    (cx, cy), by default (h / 2, w / 2), as the host's random_rotate passes
    it."""
    cx, cy = (h / 2.0, w / 2.0) if center is None else center
    # the scalars in float32 on the host, as the JAX function takes them on
    # the device: no copy to the device, which would wait for its queue
    a = -np.float32(angle_deg) * np.float32(math.pi) / np.float32(180.0)
    ca, sa = float(np.cos(a)), float(np.sin(a))
    yy, xx = _grid(h, w, device)
    mx = ca * (xx - cx) + sa * (yy - cy) + cx
    my = -sa * (xx - cx) + ca * (yy - cy) + cy
    return mx, my


def rescale_coords(f, h: int, w: int, out_h: int | None = None, out_w: int | None = None,
                   device=None):
    """(mx, my) of cv2.resize(fx=fy=f) of an (h, w) image followed by a
    centre crop (f > 1) or a numpy 'reflect' pad (f < 1) to (out_h, out_w),
    by default (h, w): the resized length round(n f), the output index moved
    into it and folded, then src = (idx + 0.5) / f - 0.5, clamped."""
    f = np.float32(f)
    out_h = h if out_h is None else out_h
    out_w = w if out_w is None else out_w

    def axis(n: int, out_n: int) -> torch.Tensor:
        # the length and offset are integers, exact in float32 on the host
        npr = float(np.round(np.float32(n) * f))
        off = np.floor((npr - out_n) / 2.0) if npr >= out_n else -np.floor((out_n - npr) / 2.0)
        idx = torch.arange(out_n, dtype=torch.float32, device=device) + float(off)
        idx = torch.where(idx < 0, -idx, idx)
        idx = torch.where(idx > npr - 1, 2 * (npr - 1) - idx, idx)
        return torch.clamp((idx + 0.5) / float(f) - 0.5, 0.0, n - 1.0)

    sy, sx = axis(h, out_h), axis(w, out_w)
    return sx[None, :].expand(out_h, out_w), sy[:, None].expand(out_h, out_w)


def elastic_field(gen: torch.Generator, h: int, w: int, alpha: float = 16.0,
                  sigma: float = 4.0, device=None):
    """(dx, dy) displacement maps gaussian_filter(U(-1, 1), sigma) * alpha,
    the reference's expression; the noise from ``gen`` (on ``device``)."""
    ux = torch.rand((h, w), generator=gen, device=device) * 2 - 1
    uy = torch.rand((h, w), generator=gen, device=device) * 2 - 1
    return gaussian_blur2d(ux, sigma) * alpha, gaussian_blur2d(uy, sigma) * alpha


def elastic_coords(dx: torch.Tensor, dy: torch.Tensor):
    yy, xx = _grid(dx.shape[0], dx.shape[1], dx.device)
    return xx + dx, yy + dy
