"""The host samplers' geometric and photometric augmentation, without cv2:
the functions of the JAX package's ``data/augment2d.py``, those that the
``CVPPPTrain``, ``BBBCTrain`` and ``AC3AC4Train`` samplers call and the
rest (``random_rotate90``, ``random_affine``, and the EM augmentations
``cutblur``, ``cutnoise``, ``mixup_batch``, ``motion_blur`` and
``missing_parts``, numpy and scipy as in the JAX package).

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


def random_rotate90(img, label, rng):
    k = int(rng.integers(0, 4))
    return np.rot90(img, k).copy(), np.rot90(label, k).copy()


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


def random_affine(img, label, rng, rotation: float = 10.0, translation: float = 0.1,
                  shear: float = 0.1, zoom=(0.7, 1.0)):
    """torchsample's RandomAffine chain (the reference's
    dataset/transforms.py:23-105: rotation +-10 degrees, translation 0.1,
    shear 0.1, zoom 0.7-1), the JAX package's ``random_affine`` without
    cv2: the matrix composed as there (translate(-c), zoom, shear, rotate,
    translate(c + t), rounded to float32), inverted in float64 as
    cv2.warpAffine inverts it, the image sampled bilinearly with a reflect
    border, the label by nearest neighbour with a 0 border. Returns an
    (H, W, C) image."""
    h, w = label.shape[:2]
    ang = np.deg2rad(rng.uniform(-rotation, rotation))
    tx = rng.uniform(-translation, translation) * w
    ty = rng.uniform(-translation, translation) * h
    sh = rng.uniform(-shear, shear)
    z = rng.uniform(*zoom)
    cx, cy = w / 2.0, h / 2.0
    ca, sa = np.cos(ang), np.sin(ang)
    a = np.array([[ca, -sa], [sa, ca]]) @ np.array([[1.0, sh], [0.0, 1.0]]) * z
    offset = np.array([cx + tx, cy + ty]) - a @ np.array([cx, cy])
    mat = np.concatenate([a, offset[:, None]], axis=1).astype(np.float32).astype(np.float64)
    inv_a = np.linalg.inv(mat[:, :2])
    inv_b = -inv_a @ mat[:, 2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mx = torch.from_numpy(inv_a[0, 0] * xx + inv_a[0, 1] * yy + inv_b[0]).float()
    my = torch.from_numpy(inv_a[1, 0] * xx + inv_a[1, 1] * yy + inv_b[1]).float()
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t[None] if t.ndim == 2 else t.permute(2, 0, 1)
    img_o = dw.remap_bilinear(t, mx, my, "reflect").permute(1, 2, 0)
    lab_o = dw.remap_nearest(torch.from_numpy(np.ascontiguousarray(label)), mx, my, "constant")
    return np.ascontiguousarray(img_o.numpy()), lab_o.numpy()


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


# ---- the EM augmentations of the reference's augmentation/ package (numpy,
# scipy): CutBlur, CutNoise, Mixup, motion blur, missing parts

def _random_region(vol_len, rng, length_ratio):
    cuboid_len = int(length_ratio * vol_len)
    low = int(rng.integers(0, max(vol_len - cuboid_len, 1)))
    return low, low + cuboid_len


def _resize_nd(vol, out_shape, order, anti_alias):
    """skimage.transform.resize-equivalent on scipy: optional gaussian
    anti-alias prefilter (sigma = (downscale - 1)/2 per axis, skimage's
    default) + spline zoom."""
    from scipy.ndimage import gaussian_filter, zoom

    in_shape = np.asarray(vol.shape, np.float64)
    out_shape = np.asarray(out_shape, np.float64)
    factors = in_shape / np.maximum(out_shape, 1)
    src = vol
    if anti_alias:
        sigma = np.maximum(0.0, (factors - 1) / 2)
        if np.any(sigma > 0):
            src = gaussian_filter(vol.astype(np.float64), sigma,
                                  mode="reflect")
    z = out_shape / in_shape
    out = zoom(src.astype(np.float64), z, order=order, mode="reflect",
               grid_mode=True)
    return out


def cutblur(stack, rng, length_ratio=0.25, down_ratio_min=2.0,
            down_ratio_max=8.0, downsample_z=False):
    """CutBlur (arXiv:2004.00448, reference augmentation/cutblur.py:5-78):
    a random cuboid is bilinearly downsampled by a random ratio (with
    anti-alias prefilter) and nearest-upsampled back, forcing learned
    super-resolution."""
    stack = stack.copy()
    zdim = stack.shape[0]
    if zdim > 1:
        zl, zh = _random_region(zdim, rng, length_ratio)
    yl, yh = _random_region(stack.shape[1], rng, length_ratio)
    xl, xh = _random_region(stack.shape[2], rng, length_ratio)
    region = (slice(None) if zdim == 1 else slice(zl, zh),
              slice(yl, yh), slice(xl, xh))
    temp = stack[region]
    down = float(rng.uniform(down_ratio_min, down_ratio_max))
    if zdim > 1 and downsample_z:
        out_shape = (np.array(temp.shape) / down).astype(int)
    else:
        out_shape = (np.array(temp.shape)
                     / np.array([1, down, down])).astype(int)
    small = _resize_nd(temp, out_shape, order=1, anti_alias=True)
    up = _resize_nd(small, temp.shape, order=0, anti_alias=False)
    stack[region] = np.clip(up, 0, 1).astype(stack.dtype)
    return stack


def cutnoise(stack, rng, length_ratio=0.25, scale=0.2):
    """CutNoise (reference augmentation/cutnoise.py): uniform noise added to
    a random cuboid, clipped to [0, 1]."""
    stack = stack.copy()
    zl, zh = _random_region(stack.shape[0], rng, length_ratio)
    yl, yh = _random_region(stack.shape[1], rng, length_ratio)
    xl, xh = _random_region(stack.shape[2], rng, length_ratio)
    temp = stack[zl:zh, yl:yh, xl:xh]
    noise = rng.uniform(-scale, scale, temp.shape)
    stack[zl:zh, yl:yh, xl:xh] = np.clip(temp + noise, 0, 1)
    return stack


def mixup_batch(batch, rng, min_ratio=0.7, max_ratio=0.9, num_aug=2):
    """Mixup over the leading batch axis (reference augmentation/mixup.py):
    num_aug random samples are blended with another random sample at a
    ratio in [min_ratio, max_ratio]."""
    batch = batch.copy()
    num_vol = batch.shape[0]
    num_aug = min(num_aug, num_vol)
    major = rng.choice(num_vol, size=num_aug, replace=False)
    for i in major:
        others = [j for j in range(num_vol) if j != i]
        j = int(rng.choice(others))
        ratio = float(rng.uniform(min_ratio, max_ratio))
        batch[i] = batch[i] * ratio + batch[j] * (1 - ratio)
    return batch


def motion_blur(stack, rng, sections=2, kernel_size=11):
    """Motion blur on random z sections (reference
    augmentation/motion_blur.py): a horizontal or vertical length-k mean
    kernel (reflect border, cv2.filter2D semantics)."""
    from scipy.ndimage import uniform_filter1d

    stack = stack.copy()
    axis = 1 if rng.random() > 0.5 else 0  # horizontal kernel blurs along x
    k = min(sections, stack.shape[0])
    selected = rng.choice(stack.shape[0], size=k, replace=True)
    for idx in selected:
        stack[idx] = uniform_filter1d(stack[idx], kernel_size, axis=axis,
                                      mode="reflect")
    return stack


def missing_parts(stack, rng, iterations=40, deformation_strength=0, p=0.5):
    """Missing-parts augmentation (reference augmentation/missing_parts.py):
    per z-slice (gated at probability p, skipping the 2 slices after an
    augmented one), a random cross-slice line is drawn, the two half-planes
    are optionally compressed toward it (deformation_strength > 0), and the
    dilated line band is filled with the slice mean. The reference's final
    reshape assumes square slices; this implementation handles any shape."""
    out = stack.copy()
    i = 0
    while i < stack.shape[0]:
        if rng.random() < p:
            out[i] = _missing_parts_slice(stack[i], rng, iterations,
                                          deformation_strength)
            i += 2  # at most one deformed slice in any 3 consecutive
        i += 1
    return out


def _bresenham_line(x0, y0, x1, y1):
    """Integer line rasterization (skimage.draw.line semantics)."""
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:
        x0, y0, x1, y1 = y0, x0, y1, x1
    swapped = x0 > x1
    if swapped:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx = x1 - x0
    dy = abs(y1 - y0)
    err = dx / 2.0
    ystep = 1 if y0 < y1 else -1
    y = y0
    rr, cc = [], []
    for x in range(x0, x1 + 1):
        if steep:
            rr.append(y)
            cc.append(x)
        else:
            rr.append(x)
            cc.append(y)
        err -= dy
        if err < 0:
            y += ystep
            err += dx
    return np.asarray(rr), np.asarray(cc)


def _missing_parts_slice(img, rng, iterations, strength):
    from scipy.ndimage import binary_dilation, label as cc_label
    from scipy.ndimage import map_coordinates

    h, w = img.shape[:2]
    fixed_x = rng.random() < 0.5
    if fixed_x:
        x0, y0 = 0, int(rng.integers(1, w - 2))
        x1, y1 = h - 1, int(rng.integers(1, w - 2))
    else:
        x0, y0 = int(rng.integers(1, h - 2)), 0
        x1, y1 = int(rng.integers(1, h - 2)), w - 1
    line_mask = np.zeros((h, w), bool)
    rr, cc = _bresenham_line(x0, y0, x1, y1)
    line_mask[rr, cc] = True

    section = img.astype(np.float64)
    mean = section.mean()
    if strength > 0:
        lv = np.array([x1 - x0, y1 - y0], np.float32)
        lv /= np.linalg.norm(lv)
        nv = np.array([-lv[1], lv[0]])
        comp, n = cc_label(~line_mask)
        neg_val = comp[0, 0] if fixed_x else comp[-1, -1]
        pos_val = comp[-1, -1] if fixed_x else comp[0, 0]
        flow_x = np.zeros((h, w))
        flow_y = np.zeros((h, w))
        flow_x[comp == pos_val] = strength * nv[1]
        flow_y[comp == pos_val] = strength * nv[0]
        flow_x[comp == neg_val] = -strength * nv[1]
        flow_y[comp == neg_val] = -strength * nv[0]
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        section = map_coordinates(section, ((y + flow_y).reshape(-1, 1),
                                            (x + flow_x).reshape(-1, 1)),
                                  mode="constant", order=3).reshape(h, w)
        section = np.clip(section, 0.0, 1.0)
    band = binary_dilation(line_mask, iterations=iterations)
    section[band] = mean
    return section.astype(img.dtype)
