"""The EMA view, generated on the device (2D).

The port of the JAX package's ``data/device_aug.py`` (2D part). From the
clean [0, 1] image (B, H, W, C) and its foreground (B, H, W), the EMA view
gets, in this order: an intensity jitter, up to 20 squares inside the
foreground's bounding box filled with the per-channel foreground mean, and
the 3-bit flip rule. Every draw comes from the ``torch.Generator`` the
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
    """Clean [0, 1] image (B, H, W, C) -> (ema_image, rules (B, 3))."""
    if noise or blur:
        raise NotImplementedError("the EMA view's Gaussian noise and blur are not ported")
    ema = img
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
