"""The EMA view, generated on the device (2D and 3D).

The port of the JAX package's ``data/device_aug.py``. 2D: from the clean
[0, 1] image (B, H, W, C) and its foreground (B, H, W), the EMA view gets,
in this order: Gaussian noise and a Gaussian blur (both off in the
presets), an intensity jitter, up to 20 squares inside the foreground's
bounding box filled with the per-channel foreground mean, and the 3-bit
flip rule. 3D: from the clean [0, 1] volume (B, D, H, W, 1), a
per-slice contrast/brightness/gamma jitter applied to half the samples, up
to 60 zeroed boxes, and the 4-bit flip rule. Every draw comes from the
``torch.Generator`` the
caller passes, so a run seeded from (seed, step) draws the same views when
it resumes (:func:`ema_generator`). The draws are not the JAX package's
bits: tests compare behaviour and distributions.
"""

from __future__ import annotations

import numpy as np
import torch


def ema_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    return gen


def _uniform(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=like.device, dtype=like.dtype)


def _randint(gen: torch.Generator, lo: torch.Tensor, hi: torch.Tensor, shape) -> torch.Tensor:
    """Integers in [lo, hi) (hi > lo), uniform, broadcast to ``shape``."""
    u = torch.rand(shape, generator=gen, device=lo.device, dtype=torch.float64)
    span = hi - lo
    return lo + torch.minimum((u * span).long(), span - 1)


def add_intensity_2d(img, gen, contrast_factor=0.1, brightness_factor=0.1):
    """out = clip(img * (1 + (u - 0.5) cf) + (v - 0.5) bf), u, v per sample."""
    b = img.shape[0]
    u = _uniform(gen, (b, 1, 1, 1), img)
    v = _uniform(gen, (b, 1, 1, 1), img)
    out = img * (1 + (u - 0.5) * contrast_factor)
    out = out + (v - 0.5) * brightness_factor
    return torch.clamp(out, 0, 1)


def add_gauss_noise_2d(img, gen, min_std=0.0, max_std=0.05):
    """clip(img + n std), std ~ U[min_std, max_std] per sample and one
    N(0, 1) field n (B, H, W, 1) over the channels."""
    b, h, w, _ = img.shape
    std = min_std + (max_std - min_std) * _uniform(gen, (b, 1, 1, 1), img)
    noise = torch.randn((b, h, w, 1), generator=gen, device=img.device, dtype=img.dtype)
    return torch.clamp(img + noise * std, 0, 1)


def add_gauss_blur_2d(img, gen, max_kernel_size=7, min_sigma=0.0, max_sigma=1.0):
    """cv2.GaussianBlur per sample: kernel 2 half + 1, half ~ U{0..3} (the
    kernel 1 is the identity), sigma ~ U[min_sigma, max_sigma]."""
    b = img.shape[0]
    r = max_kernel_size // 2
    zero = torch.zeros(b, dtype=torch.long, device=img.device)
    half = _randint(gen, zero, zero + r + 1, (b,))
    sigma = min_sigma + (max_sigma - min_sigma) * _uniform(gen, (b,), img)
    return _gauss_blur_2d(img, half, sigma, r)


def _reflect101_index(n: int, r: int, device) -> torch.Tensor:
    """Indices -r .. n + r - 1 folded into [0, n) with cv2's
    BORDER_REFLECT_101 (the edge not repeated)."""
    i = torch.arange(-r, n + r, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _gauss_blur_2d(img, half, sigma, r):
    """The separable Gaussian blur of (B, H, W, C) with per-sample radius
    ``half`` (B,) (<= r) and ``sigma`` (B,), as the JAX function: cv2's
    GaussianBlur where sigma > 0; sigma <= 0 taken from the kernel size by
    cv2's formula, 0.3 ((k - 1) / 2 - 1) + 0.8 (cv2 itself has fixed tables
    for kernels up to 7 there); taps beyond the radius weigh 0; REFLECT_101
    borders; the result clipped to [0, 1]."""
    ksz = (2 * half + 1).to(img.dtype)
    sig = torch.where(sigma > 0, sigma, 0.3 * ((ksz - 1) * 0.5 - 1) + 0.8)
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    wts = torch.exp(-(x[None, :] ** 2) / (2 * sig[:, None] ** 2))
    wts = torch.where(x.abs()[None, :] <= half[:, None], wts, torch.zeros_like(wts))
    wts = wts / wts.sum(dim=1, keepdim=True)  # (B, 2r + 1)

    def pass_axis(e, axis):
        n = e.shape[axis]
        ep = e.index_select(axis, _reflect101_index(n, r, e.device))
        out = torch.zeros_like(e)
        for d in range(2 * r + 1):
            out = out + wts[:, d, None, None, None] * ep.narrow(axis, d, n)
        return out

    return torch.clamp(pass_axis(pass_axis(img, 1), 2), 0, 1)


def _first_true(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.argmax(x.to(torch.uint8), dim=dim)


def add_mask_2d(img, fg_bhw, gen, max_counts=20, max_size=20):
    """Fill ``counts`` random size x size squares inside the foreground's
    bounding box with the per-channel foreground mean; counts ~ U{0..20},
    size ~ U{0..20} per sample, and no square where the box is no larger
    than the size (the reference's gate)."""
    b, h, w, _ = img.shape
    dev = img.device
    fgb = fg_bhw > 0
    any_row, any_col = fgb.any(dim=2), fgb.any(dim=1)  # (B, H), (B, W)
    has_fg = any_row.any(dim=1)
    x0 = _first_true(any_row, 1)
    x1 = h - 1 - _first_true(any_row.flip(1), 1)
    y0 = _first_true(any_col, 1)
    y1 = w - 1 - _first_true(any_col.flip(1), 1)

    zero = torch.zeros(b, dtype=torch.long, device=dev)
    counts = _randint(gen, zero, zero + max_counts + 1, (b,))
    size = _randint(gen, zero, zero + max_size + 1, (b,))
    can = (x1 - size > x0) & (y1 - size > y0) & has_fg
    my = _randint(gen, x0[:, None], torch.maximum(x1 - size, x0 + 1)[:, None],
                  (b, max_counts))
    mx = _randint(gen, y0[:, None], torch.maximum(y1 - size, y0 + 1)[:, None],
                  (b, max_counts))
    active = (torch.arange(max_counts, device=dev)[None] < counts[:, None]) & can[:, None]
    yy = torch.arange(h, device=dev)[None, None]
    xx = torch.arange(w, device=dev)[None, None]
    end = (size[:, None] + my)[..., None], (size[:, None] + mx)[..., None]
    rows = (yy >= my[..., None]) & (yy < end[0]) & active[..., None]  # (B, n, H)
    cols = (xx >= mx[..., None]) & (xx < end[1])                      # (B, n, W)
    # a pixel is covered when one active square holds both its row and column
    covered = torch.bmm(rows.transpose(1, 2).to(img.dtype), cols.to(img.dtype)) > 0
    keep = (~covered).to(img.dtype)[..., None]
    fg = fgb.to(img.dtype)
    denom = torch.clamp(fg.sum(dim=(1, 2)), min=1.0)
    means = (img * fg[..., None]).sum(dim=(1, 2)) / denom[:, None]  # (B, C)
    return img * keep + (1 - keep) * means[:, None, None, :]


def flip_2d(img, rules_b3):
    """The forward 3-bit flip (x, y, transpose) on (B, H, W, C); H == W for
    the transpose. Inverse of ``consistency.convert_consistency_flip``."""
    r = rules_b3.bool()
    e = torch.where(r[:, 0, None, None, None], img.flip(2), img)
    e = torch.where(r[:, 1, None, None, None], e.flip(1), e)
    return torch.where(r[:, 2, None, None, None], e.transpose(1, 2), e)


def ema_view_2d(img, fg_bhw, gen, *, noise=False, blur=False, intensity=True,
                mask=True, flip=True):
    """Clean [0, 1] image (B, H, W, C) -> (ema_image, rules (B, 3)); the
    links in the reference's order: noise, blur, intensity, mask, flip."""
    ema = img
    if noise:
        ema = add_gauss_noise_2d(ema, gen)
    if blur:
        ema = add_gauss_blur_2d(ema, gen)
    if intensity:
        ema = add_intensity_2d(ema, gen)
    if mask:
        ema = add_mask_2d(ema, fg_bhw, gen)
    b = img.shape[0]
    if flip:
        rules = (_uniform(gen, (b, 3), img) < 0.5).to(img.dtype)
        ema = flip_2d(ema, rules)
    else:
        rules = torch.zeros((b, 3), dtype=img.dtype, device=img.device)
    return ema, rules


def ema_intensity_params_3d(gen, b: int, d: int, like: torch.Tensor, contrast_factor=0.1,
                            brightness_factor=0.1, exec_ratio=0.5):
    """The 3D intensity jitter's draws: (do (B, 1, 1, 1, 1) bool gate with
    p = exec_ratio, and per slice (B, D, 1, 1, 1) the contrast
    1 + (u - 0.5) cf, the brightness (u - 0.5) bf and the gamma 2^(2u - 1),
    log-uniform in [0.5, 2])."""
    do = _uniform(gen, (b, 1, 1, 1, 1), like) < exec_ratio
    shape = (b, d, 1, 1, 1)
    c = 1.0 + (_uniform(gen, shape, like) - 0.5) * contrast_factor
    br = (_uniform(gen, shape, like) - 0.5) * brightness_factor
    g = 2.0 ** (_uniform(gen, shape, like) * 2 - 1)
    return do, c, br, g


def intensity_3d(img, gen, contrast_factor=0.1, brightness_factor=0.1, exec_ratio=0.5):
    """Per sample with p = exec_ratio, per slice: clip(img * c + br), then
    clip(. ** g), both to [0, 1]; the reference's parameters are always
    per slice (its 3D mode can never be drawn)."""
    do, c, br, g = ema_intensity_params_3d(gen, img.shape[0], img.shape[1], img,
                                           contrast_factor, brightness_factor, exec_ratio)
    out = torch.clamp(img * c + br, 0, 1)
    out = torch.clamp(out ** g, 0, 1)
    return torch.where(do, out, img)


def cutout_3d(img, gen, max_counts=60, min_size=(5, 10, 10), max_size=(10, 20, 20)):
    """Zero ``counts`` ~ U{0..60} boxes of one (sz, sxy) size pair per
    sample, sz ~ U{5..10}, sxy ~ U{10..20}, each box's corner uniform in
    [0, max(dim - size, 1)) per axis."""
    b, d, h, w = img.shape[:4]
    dev = img.device
    zero = torch.zeros(b, dtype=torch.long, device=dev)
    counts = _randint(gen, zero, zero + max_counts + 1, (b,))
    sz = _randint(gen, zero + min_size[0], zero + max_size[0] + 1, (b,))
    sxy = _randint(gen, zero + min_size[1], zero + max_size[1] + 1, (b,))
    one = torch.ones_like(zero)
    mz = _randint(gen, zero[:, None], torch.maximum(d - sz, one)[:, None], (b, max_counts))
    my = _randint(gen, zero[:, None], torch.maximum(h - sxy, one)[:, None], (b, max_counts))
    mx = _randint(gen, zero[:, None], torch.maximum(w - sxy, one)[:, None], (b, max_counts))
    active = torch.arange(max_counts, device=dev)[None] < counts[:, None]

    def span(start, size, n):  # (B, n_boxes, n): inside the box along one axis
        i = torch.arange(n, device=dev)[None, None]
        return (i >= start[..., None]) & (i < (start + size[:, None])[..., None])

    zy = (span(mz, sz, d) & active[..., None])[..., :, None] & span(my, sxy, h)[..., None, :]
    # a voxel is zeroed when one active box holds its (z, y) and its x
    covered = torch.bmm(zy.reshape(b, max_counts, d * h).transpose(1, 2).to(img.dtype),
                        span(mx, sxy, w).to(img.dtype)) > 0
    return img * (~covered).reshape(b, d, h, w, 1).to(img.dtype)


def flip_3d_rule4(img, rules_b4):
    """The forward 4-bit flip (z, x, y, xy-transpose) on (B, D, H, W, C); H
    == W for the transpose. Inverse of
    ``ac3ac4.convert_consistency_flip_3d_rule4``."""
    r = rules_b4.bool()

    def bit(i):
        return r[:, i, None, None, None, None]

    e = torch.where(bit(0), img.flip(1), img)
    e = torch.where(bit(1), e.flip(3), e)
    e = torch.where(bit(2), e.flip(2), e)
    return torch.where(bit(3), e.transpose(2, 3), e)


def ema_view_3d(img, gen, *, intensity=True, mask=True, flip=True):
    """Clean [0, 1] volume (B, D, H, W, 1) -> (ema_image, rules (B, 4))."""
    ema = img
    if intensity:
        ema = intensity_3d(ema, gen)
    if mask:
        ema = cutout_3d(ema, gen)
    b = img.shape[0]
    if flip:
        rules = (_uniform(gen, (b, 4), img) < 0.5).to(img.dtype)
        ema = flip_3d_rule4(ema, rules)
    else:
        rules = torch.zeros((b, 4), dtype=img.dtype, device=img.device)
    return ema, rules
