"""The host samplers' geometric and photometric augmentation, without cv2:
the functions of the JAX package's ``data/augment2d.py`` that the
``CVPPPTrain``, ``BBBCTrain`` and ``AC3AC4Train`` samplers call.

Each takes its draws from a ``np.random.Generator`` in the JAX function's
order, so one seed gives the same flips, crop boxes, angles, factors and
fields. Image and label move together (image bilinear, label nearest).
The warps follow cv2's conventions: resizes in numpy
(:func:`resize_linear`, :func:`resize_nearest`: cv2.resize's source
coordinates and taps), rotations and elastic remaps through
:mod:`.device_warp` on CPU tensors. Float32 images agree with cv2's
within the bars of the JAX package's device-warp tests (remap 1e-5,
rotation 2e-5, resize 1e-4; measured at most 3e-5), labels everywhere but
at rounding ties of the nearest neighbour.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import device_warp as dw


def random_flips(img, label, rng):
    if rng.random() < 0.5:
        img = img[:, ::-1]
        label = label[:, ::-1]
    if rng.random() < 0.5:
        img = img[::-1]
        label = label[::-1]
    return np.ascontiguousarray(img), np.ascontiguousarray(label)


def _linear_taps(n: int, out: int, scale: float):
    """cv2.resize INTER_LINEAR's taps along one axis: src = (dst + 0.5)
    scale - 0.5 in float32, (floor, floor + 1, weight of the second),
    clamped to the edge pixel with weight 0 outside."""
    d = np.arange(out, dtype=np.float64)
    fx = ((d + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    lo, hi = sx < 0, sx >= n - 1
    fx[lo | hi] = 0
    sx[lo] = 0
    sx[hi] = n - 1
    return sx, np.minimum(sx + 1, n - 1), fx


def resize_linear(img: np.ndarray, out_h: int, out_w: int, scale_y: float,
                  scale_x: float) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of a float32 (H, W) or (H, W, C) image to
    (out_h, out_w), source pixel (dst + 0.5) * scale - 0.5: the rows
    first, then the columns, in float32. At the input's own size cv2
    copies, whatever the scale."""
    if (out_h, out_w) == img.shape[:2]:
        return img.astype(np.float32, copy=True)
    x0, x1, ax = _linear_taps(img.shape[1], out_w, scale_x)
    y0, y1, ay = _linear_taps(img.shape[0], out_h, scale_y)
    tail = (None,) * (img.ndim - 2)
    ax, ay = ax[(None, slice(None)) + tail], ay[(slice(None), None) + tail]
    rows = img[:, x0] * (np.float32(1) - ax) + img[:, x1] * ax
    return (rows[y0] * (np.float32(1) - ay) + rows[y1] * ay).astype(np.float32)


def resize_nearest(label: np.ndarray, out_h: int, out_w: int, scale_y: float,
                   scale_x: float) -> np.ndarray:
    """cv2.resize(INTER_NEAREST): source index floor(dst * scale) in float64,
    clamped; a copy at the input's own size."""
    if (out_h, out_w) == label.shape[:2]:
        return label.copy()

    def idx(n, out, scale):
        return np.minimum(np.floor(np.arange(out) * scale).astype(np.int64), n - 1)

    return np.ascontiguousarray(label[idx(label.shape[0], out_h, scale_y)]
                                [:, idx(label.shape[1], out_w, scale_x)])


def _resize_to(img, label, out_h, out_w):
    """Both resized to (out_h, out_w) as cv2.resize(dsize=...) does: scale
    1 / (out / n) per axis."""
    sy, sx = 1.0 / (out_h / label.shape[0]), 1.0 / (out_w / label.shape[1])
    return (resize_linear(img, out_h, out_w, sy, sx),
            resize_nearest(label, out_h, out_w, sy, sx))


def random_resized_crop(img, label, out_size, rng, scale=(0.7, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision's RandomResizedCrop: 10 attempts at an area fraction and
    a log-uniform aspect, else the centre crop; the box resized to
    (out_size, out_size)."""
    h, w = label.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            break
    else:
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw = w
            ch = int(round(cw / ratio[0]))
        elif in_ratio > ratio[1]:
            ch = h
            cw = int(round(ch * ratio[1]))
        else:
            cw, ch = w, h
        i = (h - ch) // 2
        j = (w - cw) // 2
    return _resize_to(np.ascontiguousarray(img[i:i + ch, j:j + cw]),
                      label[i:i + ch, j:j + cw], out_size, out_size)


def _warp(img, label, mx, my, border: str):
    """img (H, W) or (H, W, C) and label (H, W) sampled at the maps (mx,
    my): bilinear and nearest, through :mod:`.device_warp`."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if t.ndim == 3:
        t = t.permute(2, 0, 1)
    out = dw.remap_bilinear(t, mx, my, border)
    if out.ndim == 3:
        out = out.permute(1, 2, 0)
    lab = dw.remap_nearest(torch.from_numpy(np.ascontiguousarray(label)), mx, my, border)
    return np.ascontiguousarray(out.numpy()), lab.numpy()


def random_rotate(img, label, rng):
    """Rotation by rand() * 360 degrees about (h / 2, w / 2), as
    cv2.warpAffine(cv2.getRotationMatrix2D(...)) with a constant 0 border."""
    h, w = label.shape[:2]
    ang = float(rng.random()) * 360.0
    mx, my = dw.rotation_coords(ang, h, w)
    return _warp(img, label, mx, my, "constant")


def random_rescale(img, label, rng, lo=0.8, hi=1.2):
    """Resize by f ~ U[lo, hi] (cv2.resize(fx=fy=f)), then centre crop or
    pad back to the original size."""
    h, w = label.shape[:2]
    f = rng.uniform(lo, hi)
    oh, ow = int(np.rint(h * f)), int(np.rint(w * f))
    img_r = resize_linear(img, oh, ow, 1.0 / f, 1.0 / f)
    lab_r = resize_nearest(label, oh, ow, 1.0 / f, 1.0 / f)
    return center_crop_pad(img_r, h, w), center_crop_pad(lab_r, h, w)


def center_crop_pad(x, th, tw):
    h, w = x.shape[:2]
    if h > th:
        o = (h - th) // 2
        x = x[o:o + th]
    if w > tw:
        o = (w - tw) // 2
        x = x[:, o:o + tw]
    h, w = x.shape[:2]
    if h < th or w < tw:
        pad = [((th - h) // 2, th - h - (th - h) // 2),
               ((tw - w) // 2, tw - w - (tw - w) // 2)]
        pad += [(0, 0)] * (x.ndim - 2)
        x = np.pad(x, pad, mode="reflect" if min(h, w) > 1 else "constant")
    return x


def elastic_field_np(rng, h, w, alpha=16.0, sigma=4.0):
    """One displacement component, ``gaussian_filter(rand(h, w) * 2 - 1,
    sigma) * alpha``: the reference's expression, shared by the BBBC and
    AC3/AC4 samplers."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(rng.random((h, w)) * 2 - 1, sigma).astype(np.float32) * alpha


def elastic_maps(rng, h, w, alpha=16.0, sigma=4.0):
    """(mx, my) float32 tensors of an elastic field, dx drawn before dy."""
    dx = elastic_field_np(rng, h, w, alpha, sigma)
    dy = elastic_field_np(rng, h, w, alpha, sigma)
    return dw.elastic_coords(torch.from_numpy(dx), torch.from_numpy(dy))


def elastic_deform(img, label, rng, alpha=16.0, sigma=4.0):
    """Elastic deformation by a smoothed uniform field, 0 outside (cv2.remap
    with BORDER_CONSTANT)."""
    mx, my = elastic_maps(rng, *label.shape[:2], alpha, sigma)
    return _warp(img, label, mx, my, "constant")


def grayscale_params(rng, contrast_factor=0.3, brightness_factor=0.3):
    """One (contrast, brightness, gamma): x(1 + (u - 0.5) cf), +(u - 0.5) bf,
    gamma 2^(2u - 1), drawn in that order."""
    c = 1.0 + (rng.random() - 0.5) * contrast_factor
    b = (rng.random() - 0.5) * brightness_factor
    g = 2.0 ** (rng.random() * 2 - 1)
    return c, b, g


def random_grayscale_adjust(img, rng, contrast_factor=0.3, brightness_factor=0.3):
    """x c + b clipped to [0, 1], then gamma."""
    c, b, g = grayscale_params(rng, contrast_factor, brightness_factor)
    out = np.clip(img * c + b, 0, 1)
    return np.clip(out ** g, 0, 1)
