"""The EMA view's flip rules and their inverse, the ImageNet constants, and
the host half of the JAX package's ``data/consistency.py``: the EMA view's
perturbations and flips on one (H, W, C) numpy image, drawn from a
``np.random.Generator`` in the JAX functions' order, for the host
samplers (:mod:`.cvppp`, :mod:`.bbbc`).

A rule is 3 bits per sample: x-flip, y-flip, xy-transpose, applied in that
order by :func:`..data.device_aug.flip_2d`. ``convert_consistency_flip``
undoes them on the teacher's embedding: transpose, then y-flip, then
x-flip, each where the sample's bit is set (branch-free, so per-sample
rules stay on the device). Tensors are (B, H, W, C), as in the JAX
package, and H == W for the transpose; the port's NCHW model output goes
in as its ``permute(0, 2, 3, 1)`` view.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)
_STATS: dict = {}


def imagenet_stats(device, dtype=torch.float32) -> tuple:
    """(mean, std) as tensors on ``device``, made once: a copy from pageable
    host memory would wait for the queued kernels at every use."""
    key = (torch.device(device), dtype)
    if key not in _STATS:
        _STATS[key] = tuple(torch.as_tensor(a, dtype=dtype, device=key[0])
                            for a in (IMAGENET_MEAN, IMAGENET_STD))
    return _STATS[key]


def _bit(rules_b3: torch.Tensor, i: int) -> torch.Tensor:
    return rules_b3[:, i].bool()[:, None, None, None]


def convert_consistency_flip(emb_bhwc: torch.Tensor, rules_b3: torch.Tensor) -> torch.Tensor:
    """Un-flip per-sample EMA embeddings (B, H, W, C); rules (B, 3). The
    result has the input's strides: ``torch.where`` takes the layout of its
    first operand, so the untransposed one goes first and the affinity
    kernels read the teacher as they read the student."""
    e = torch.where(~_bit(rules_b3, 2), emb_bhwc, emb_bhwc.transpose(1, 2))
    e = torch.where(_bit(rules_b3, 1), e.flip(1), e)
    return torch.where(_bit(rules_b3, 0), e.flip(2), e)


def normalize_imagenet(img_hwc: np.ndarray) -> np.ndarray:
    return (img_hwc.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(img_hwc: np.ndarray) -> np.ndarray:
    return img_hwc * IMAGENET_STD + IMAGENET_MEAN


def simple_augment(data_hwc: np.ndarray, rule) -> np.ndarray:
    """The 3-bit rule (x-flip, y-flip, xy-transpose) on an HWC image."""
    if rule[0]:
        data_hwc = data_hwc[:, ::-1]
    if rule[1]:
        data_hwc = data_hwc[::-1]
    if rule[2]:
        data_hwc = np.transpose(data_hwc, (1, 0, 2))
    return data_hwc


def simple_augment_reverse(data_hwc: np.ndarray, rule) -> np.ndarray:
    if rule[2]:
        data_hwc = np.transpose(data_hwc, (1, 0, 2))
    if rule[1]:
        data_hwc = data_hwc[::-1]
    if rule[0]:
        data_hwc = data_hwc[:, ::-1]
    return data_hwc


def flip_ema_rule(rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 2, size=3).astype(np.float32)


def add_gauss_noise(img_hwc, rng, min_std=0.0, max_std=0.05):
    """One N(0, std) field over the channels, std ~ U[min_std, max_std]."""
    std = rng.uniform(min_std, max_std) if max_std > min_std else min_std
    noise = rng.normal(0, std, img_hwc.shape[:2])[..., None]
    return np.clip(img_hwc + noise, 0, 1)


def add_gauss_blur(img_hwc, rng, max_kernel_size=7, min_sigma=0.0, max_sigma=1.0):
    """cv2.GaussianBlur with a (k, k) kernel, k = 2 U{0..3} + 1, sigma ~
    U[min_sigma, max_sigma], through the device view's blur
    (:func:`.device_aug.add_gauss_blur_2d`'s) on a CPU tensor."""
    from .device_aug import _gauss_blur_2d

    k = int(rng.integers(0, max_kernel_size // 2 + 1)) * 2 + 1
    sigma = rng.uniform(min_sigma, max_sigma)
    x = torch.from_numpy(np.ascontiguousarray(img_hwc, np.float32))[None]
    out = _gauss_blur_2d(x, torch.tensor([k // 2]), torch.tensor([sigma], dtype=torch.float32),
                         max_kernel_size // 2)[0].numpy()
    return np.clip(out, 0, 1)


def add_intensity(img_hwc, rng, contrast_factor=0.1, brightness_factor=0.1):
    out = img_hwc * (1 + (rng.random() - 0.5) * contrast_factor)
    out = out + (rng.random() - 0.5) * brightness_factor
    return np.clip(out, 0, 1)


def add_mask(img_hwc, label_mask, rng, min_counts=0, max_counts=20, min_size=0,
             max_size=20):
    """Up to ``max_counts`` squares inside the foreground's bounding box
    filled with the per-channel foreground mean."""
    xs, ys = np.where(label_mask == 1)
    if len(xs) == 0:
        return img_hwc
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    counts = int(rng.integers(min_counts, max_counts + 1))
    size = int(rng.integers(min_size, max_size + 1))
    mask = np.ones(img_hwc.shape[:2], dtype=np.float32)
    if x1 - size > x0 and y1 - size > y0:
        for _ in range(counts):
            my = int(rng.integers(x0, max(x1 - size, x0 + 1)))
            mx = int(rng.integers(y0, max(y1 - size, y0 + 1)))
            mask[my:my + size, mx:mx + size] = 0
    fg = label_mask[..., None].astype(np.float32)
    denom = max(label_mask.sum(), 1)
    means = (img_hwc * fg).sum(axis=(0, 1)) / denom
    return img_hwc * mask[..., None] + (1 - mask[..., None]) * means
