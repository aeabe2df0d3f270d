"""Device-resident BBBC039V1 training data: the BBBC half of the JAX
package's ``data/device_data.py``.

The training set is padded once (numpy 'reflect', ``data.bbbc_padding``)
and uploaded once; each step then picks the images, crops
(size + 2 * padding)^2 windows, runs the reference's augmentation chain
and centre-crops size^2 on the device, with no host copy of image data.
The chain, on ``AUG_PROB`` (0.8) of the samples, each link gated at
0.5 as the reference's augs_mix gates them: flips (each axis at 0.5),
rotation by an angle uniform in [0, 360) with a zero fill, rescaling by a
factor uniform in [0.8, 1.2), an elastic warp (alpha 16, sigma 4, zero
fill) and a grayscale jitter (contrast, brightness, gamma). Labels follow
the geometric links with nearest sampling.

The draws of a batch come from a CPU ``torch.Generator`` seeded by (seed,
step) (:func:`sampler_generator`), so drawing costs no device sync and a
resumed run draws what an uninterrupted one drew; the elastic noise comes
from a generator on the data's device seeded from it. The draws are not
the JAX package's bits: the tests hold the warps at fixed parameters and
the sampler by its contract and gate rates.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device_warp as dw
from .bbbc import load_pairs

# distinct from the EMA view's (seed, step) stream, as the JAX loop folds
# 55991 into its sampler key
_STREAM = 55991
# the share of samples that go through the augmentation chain
AUG_PROB = 0.8


def sampler_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step)."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence([seed, _STREAM, step]).generate_state(1)[0]))
    return gen


def pad_bbbc_arrays(pairs, padding: int = 30):
    """(image, label) pairs -> (images float32 (N, H + 2p, W + 2p), labels
    int32), each padded with numpy's 'reflect'."""
    imgs = [np.pad(img, padding, mode="reflect") for img, _ in pairs]
    labs = [np.pad(lab, padding, mode="reflect") for _, lab in pairs]
    return np.stack(imgs).astype(np.float32), np.stack(labs).astype(np.int32)


def load_bbbc_arrays(data_folder: str, padding: int = 30):
    """The training split read from disk (cv2), normalised and padded."""
    return pad_bbbc_arrays(load_pairs(data_folder, "train"), padding)


def _uniform(gen: torch.Generator, n: int = 1) -> list[float]:
    return torch.rand(n, generator=gen, dtype=torch.float64).tolist()


def _grayscale_params(gen: torch.Generator):
    """(contrast 1 + 0.3 (u - 0.5), brightness 0.3 (u - 0.5), gamma
    2^(2u - 1))."""
    uc, ub, ug = _uniform(gen, 3)
    return 1.0 + (uc - 0.5) * 0.3, (ub - 0.5) * 0.3, 2.0 ** (ug * 2 - 1)


def _grayscale_single(img: torch.Tensor, c: float, b: float, g: float) -> torch.Tensor:
    """The grayscale jitter of one map: clip(clip(img c + b) ^ g), to [0, 1]."""
    out = torch.clamp(img * c + b, 0.0, 1.0)
    return torch.clamp(out ** g, 0.0, 1.0)


def _bbbc_aug_params(gen: torch.Generator) -> dict:
    """One sample's draws of the chain: each link's gate and parameters
    (``elastic`` is a seed for the noise, or None when off)."""
    (g_flip, u_fx, u_fy, g_rot, u_ang, g_sc, u_sc, g_el, g_gs) = _uniform(gen, 9)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    gray = _grayscale_params(gen)
    flip = g_flip > 0.5
    return {"flip_x": flip and u_fx < 0.5, "flip_y": flip and u_fy < 0.5,
            "angle": u_ang * 360.0 if g_rot > 0.5 else None,
            "scale": 0.8 + 0.4 * u_sc if g_sc < 0.5 else None,
            "elastic": seed if g_el < 0.5 else None,
            "gray": gray if g_gs < 0.5 else None}


def _bbbc_aug(img: torch.Tensor, lab: torch.Tensor, p: dict):
    """The chain on one (crop, crop) image and label at the parameters
    ``p`` (:func:`_bbbc_aug_params`; ``elastic`` as the (dx, dy) field)."""
    h, w = lab.shape
    dev = img.device
    if p["flip_x"]:
        img, lab = img.flip(1), lab.flip(1)
    if p["flip_y"]:
        img, lab = img.flip(0), lab.flip(0)
    if p["angle"] is not None:
        mx, my = dw.rotation_coords(p["angle"], h, w, device=dev)
        img, lab = (dw.remap_bilinear(img, mx, my, "constant"),
                    dw.remap_nearest(lab, mx, my, "constant"))
    if p["scale"] is not None:
        mx, my = dw.rescale_coords(p["scale"], h, w, device=dev)
        img, lab = (dw.remap_bilinear(img, mx, my, "reflect"),
                    dw.remap_nearest(lab, mx, my, "reflect"))
    if p["elastic"] is not None:
        # the reference's Elastic fills 0 outside
        mx, my = dw.elastic_coords(*p["elastic"])
        img, lab = (dw.remap_bilinear(img, mx, my, "constant"),
                    dw.remap_nearest(lab, mx, my, "constant"))
    if p["gray"] is not None:
        img = _grayscale_single(img, *p["gray"])
    return img, lab


def sample_bbbc(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                size: int = 256, padding: int = 30) -> dict:
    """One training sample from the padded stacks (on any device): an
    image, a random (size + 2 padding)^2 crop, the chain at p =
    ``AUG_PROB``, the centre size^2, the grayscale repeated to 3 channels.
    Returns {'image': (size, size, 3) float32, 'seg': (size, size) int32}."""
    n, hp, wp = labels.shape
    crop = size + 2 * padding
    k = int(torch.randint(0, n, (1,), generator=gen))
    ry = int(torch.randint(0, hp - crop + 1, (1,), generator=gen))
    rx = int(torch.randint(0, wp - crop + 1, (1,), generator=gen))
    (u_aug,) = _uniform(gen)
    p = _bbbc_aug_params(gen)
    img = images[k, ry:ry + crop, rx:rx + crop]
    lab = labels[k, ry:ry + crop, rx:rx + crop]
    if u_aug < AUG_PROB:
        if p["elastic"] is not None:
            dev_gen = torch.Generator(device=images.device).manual_seed(p["elastic"])
            p["elastic"] = dw.elastic_field(dev_gen, crop, crop, device=images.device)
        img, lab = _bbbc_aug(img, lab, p)
    img = img[padding:padding + size, padding:padding + size]
    lab = lab[padding:padding + size, padding:padding + size]
    return {"image": img[..., None].expand(size, size, 3).contiguous(),
            "seg": lab.contiguous()}


def sample_bbbc_batch(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                      batch_size: int, size: int = 256, padding: int = 30) -> dict:
    """``batch_size`` samples stacked: image (B, size, size, 3), seg (B,
    size, size)."""
    samples = [sample_bbbc(images, labels, gen, size, padding)
               for _ in range(batch_size)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
