"""AC3/AC4 EM volumes, the JAX package's ``data/ac3ac4.py``: the host
training sampler ``AC3AC4Train`` with its augmentation and EMA view,
``AC3AC4ValidVolume`` for tiled serving, ``synthesize_volume``, the
inverse of the EMA view's 4-bit flip ``convert_consistency_flip_3d_rule4``;
and ``label_affinities``, a synthetic canvas for the decoders. Volumes are
HDF5 files with one dataset ``main``: ``AC4_inputs.h5``/``AC4_labels.h5``
and ``AC3_inputs.h5``/``AC3_labels.h5`` in one folder.

``AC3AC4Train`` takes the first ``train_split`` slices (labels' borders
widened), and a sample is a random (18, 160 + 2 padding, 160 + 2 padding)
crop, at p = 0.5 the augmentation mix (flips, rot90, one elastic field
for every slice, grayscale, missing sections or misalignment), the centre
(18, 160, 160); then the image and labels alone with ``light``
(``data.device_gt``), plus the EMA view and its 4-bit rule unless
``device_ema``, or every target on the host. Draws from a
``np.random.Generator`` in the JAX sampler's order; the elastic remap runs
through :mod:`.device_warp` on CPU tensors, without cv2."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.affinity_np import (label_pyramid, seg_to_aff_3d, seg_to_aff_3d_12ch,
                               seg_widen_border, weight_binary_ratio)
from . import device_warp as dw
from .augment2d import elastic_maps, random_grayscale_adjust

_FILES = {"ac4": ("AC4_inputs.h5", "AC4_labels.h5"),
          "ac3": ("AC3_inputs.h5", "AC3_labels.h5")}


def read_volume(data_folder: str, dataset_name: str = "ac4") -> tuple[np.ndarray, np.ndarray]:
    """(raw, label) of ``dataset_name``, each its HDF5 file's ``main``
    (h5py, imported here)."""
    import h5py

    out = []
    for name in _FILES[dataset_name]:
        with h5py.File(os.path.join(data_folder, name), "r") as f:
            out.append(f["main"][:])
    return tuple(out)


class AC3AC4ValidVolume:
    """A whole volume for tiled inference: ``raw`` float32 in [0, 1] and
    ``label`` int64, both (D, H, W).

    ``ac3`` serves its first 100 slices (the test split). ``ac4`` serves its
    last 20 slices when ``mode == "valid"`` (the validation split), and the
    whole volume in any other mode. ``arrays=(raw, label)`` stands in for
    the files (h5py is read only when they are)."""

    def __init__(self, data_folder: str, dataset_name: str = "ac4",
                 mode: str = "valid",
                 arrays: tuple[np.ndarray, np.ndarray] | None = None):
        raw, label = read_volume(data_folder, dataset_name) if arrays is None else arrays
        if dataset_name == "ac3":
            raw, label = raw[:100], label[:100]
        elif mode == "valid":
            raw, label = raw[-20:], label[-20:]
        self.raw = raw.astype(np.float32) / 255.0
        self.label = label.astype(np.int64)


def simple_augment_3d(data: np.ndarray, rule) -> np.ndarray:
    """The 4-bit rule: z-flip, x-flip, y-flip, xy-transpose on (D, H, W)."""
    if rule[0]:
        data = data[::-1]
    if rule[1]:
        data = data[:, :, ::-1]
    if rule[2]:
        data = data[:, ::-1, :]
    if rule[3]:
        data = np.transpose(data, (0, 2, 1))
    return data


def simple_augment_reverse_3d(data: np.ndarray, rule) -> np.ndarray:
    if rule[3]:
        data = np.transpose(data, (0, 2, 1))
    if rule[2]:
        data = data[:, ::-1, :]
    if rule[1]:
        data = data[:, :, ::-1]
    if rule[0]:
        data = data[::-1]
    return data


def gen_mask_3d(shape, rng, min_counts=0, max_counts=60, min_size=(5, 10, 10),
                max_size=(10, 20, 20)) -> np.ndarray:
    """The EMA view's cutout: up to ``max_counts`` zeroed boxes."""
    mask = np.ones(shape, np.float32)
    counts = int(rng.integers(min_counts, max_counts + 1))
    sz = int(rng.integers(min_size[0], max_size[0] + 1))
    sxy = int(rng.integers(min_size[1], max_size[1] + 1))
    for _ in range(counts):
        mz = int(rng.integers(0, max(shape[0] - sz, 1)))
        my = int(rng.integers(0, max(shape[1] - sxy, 1)))
        mx = int(rng.integers(0, max(shape[2] - sxy, 1)))
        mask[mz:mz + sz, my:my + sxy, mx:mx + sxy] = 0
    return mask


def missing_section_augment(imgs, rng, max_sections: int = 2, fill_mode: str = "mix"):
    """A few random z-slices blanked (0) or filled with uniform noise."""
    out = imgs.copy()
    n = int(rng.integers(1, max_sections + 1))
    for z in rng.choice(imgs.shape[0], size=min(n, imgs.shape[0]), replace=False):
        if fill_mode == "noise" or (fill_mode == "mix" and rng.random() < 0.5):
            out[z] = rng.random(imgs.shape[1:]).astype(imgs.dtype)
        else:
            out[z] = 0.0
    return out


def misalign_augment(imgs, label, rng, max_shift: int = 10):
    """The slices from a random z on shifted rigidly in y and x, the label
    with them (0 where nothing moves in)."""
    z0 = int(rng.integers(1, imgs.shape[0]))
    dy = int(rng.integers(-max_shift, max_shift + 1))
    dx = int(rng.integers(-max_shift, max_shift + 1))
    if dy == 0 and dx == 0:
        return imgs, label

    def shift2d(a, fill):
        out = np.full_like(a, fill)
        h, w = a.shape
        out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
            a[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
        return out

    imgs, label = imgs.copy(), label.copy()
    for z in range(z0, imgs.shape[0]):
        imgs[z] = shift2d(imgs[z], 0.0)
        label[z] = shift2d(label[z], 0)
    return imgs, label


def intensity_augment_3d(imgs, rng, mode="mix", contrast_factor=0.3, brightness_factor=0.3):
    """Contrast/brightness/gamma jitter per slice ("2D") or for the whole
    volume ("3D"); "mix" picks one at 0.5."""
    if mode == "mix":
        mode = "3D" if rng.random() > 0.5 else "2D"
    if mode == "2D":
        return np.stack([random_grayscale_adjust(imgs[z], rng, contrast_factor,
                                                 brightness_factor)
                         for z in range(imgs.shape[0])])
    return random_grayscale_adjust(imgs, rng, contrast_factor, brightness_factor)


def _center_crop_3d(x, det):
    off = [(x.shape[i] - det[i]) // 2 for i in range(3)]
    return x[off[0]:off[0] + det[0], off[1]:off[1] + det[1], off[2]:off[2] + det[2]]


def host_targets_3d(lb: np.ndarray) -> dict:
    """The 3D targets of one (D, H, W) label crop, as the JAX package's
    host sampler builds them: ``affs`` and ``wmap`` (12, D, H, W) and
    ``down1..4``, each pyramid level's unit-shift targets and weights
    stacked along channels (6, D, H / 2^k, W / 2^k)."""
    affs = seg_to_aff_3d_12ch(lb).astype(np.float32)
    out = {"affs": affs, "wmap": np.stack([weight_binary_ratio(affs[i]) for i in range(12)])}
    for lvl, lab_d in enumerate(label_pyramid(lb, num_levels=4)):
        a = seg_to_aff_3d(lab_d).astype(np.float32)
        w = np.stack([weight_binary_ratio(a[i]) for i in range(3)])
        out[f"down{lvl + 1}"] = np.concatenate([a, w], axis=0)
    return out


class AC3AC4Train:
    """The training sampler: ``sample(rng)`` -> one sample dict (see the
    module's docstring). ``arrays=(raw, labels)`` stands in for the HDF5
    files (h5py is read only when they are)."""

    def __init__(self, data_folder: str = "", dataset_name: str = "ac4", train_split: int = 80,
                 crop_size=(18, 160, 160), padding: int = 50, if_dilate: bool = True,
                 aug_prob: float = 0.5, ema_intensity: bool = True, ema_mask: bool = True,
                 ema_flip: bool = True, seed: int = 555, light: bool = False,
                 device_ema: bool = False, arrays=None):
        self.crop_size = list(crop_size)
        self.aug_prob = aug_prob
        self.ema_intensity, self.ema_mask, self.ema_flip = ema_intensity, ema_mask, ema_flip
        self.light, self.device_ema = light, device_ema
        self.rng = np.random.default_rng(seed)
        raw, label = read_volume(data_folder, dataset_name) if arrays is None else arrays
        raw = raw[:train_split]
        label = label[:train_split].astype(np.int64)
        if if_dilate:
            label = seg_widen_border(label, tsz_h=1)
        if raw.shape[0] < self.crop_size[0]:  # z-pad a volume thinner than the crop
            pz = (self.crop_size[0] - raw.shape[0]) // 2
            pz2 = self.crop_size[0] - raw.shape[0] - pz
            raw = np.pad(raw, ((pz, pz2), (0, 0), (0, 0)), mode="reflect")
            label = np.pad(label, ((pz, pz2), (0, 0), (0, 0)), mode="reflect")
        self.raw, self.label = raw, label
        self.crop_from_origin = [self.crop_size[0], self.crop_size[1] + 2 * padding,
                                 self.crop_size[2] + 2 * padding]

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng or self.rng
        shp, cfo = self.raw.shape, self.crop_from_origin
        rz = int(rng.integers(0, shp[0] - cfo[0] + 1))
        ry = int(rng.integers(0, shp[1] - cfo[1] + 1))
        rx = int(rng.integers(0, shp[2] - cfo[2] + 1))
        imgs = self.raw[rz:rz + cfo[0], ry:ry + cfo[1], rx:rx + cfo[2]].astype(np.float32) / 255.0
        lb = self.label[rz:rz + cfo[0], ry:ry + cfo[1], rx:rx + cfo[2]].copy()
        if rng.random() < self.aug_prob:
            imgs, lb = self._augs_mix(imgs, lb, rng)
        imgs = _center_crop_3d(imgs, self.crop_size)
        lb = _center_crop_3d(lb, self.crop_size)
        image = np.ascontiguousarray(imgs, np.float32)[..., None]
        if self.light:
            out = {"image": image, "seg": lb.astype(np.int32)}
            if not self.device_ema:
                out["ema_image"], out["rules"] = self._ema_view(imgs, rng)
            return out
        out = host_targets_3d(lb)
        ema, rule = self._ema_view(imgs, rng)
        return {"image": image, "ema_image": ema, **out, "seg": lb.astype(np.int32),
                "rules": rule}

    def _ema_view(self, imgs, rng):
        """(EMA view (D, H, W, 1), rule (4,)): at 0.5 a per-slice intensity
        jitter (factors 0.1; the reference's rule reaches only the per-slice
        form), the cutout, the 4-bit flip."""
        ema = imgs.copy()
        if self.ema_intensity and rng.random() < 0.5:
            ema = intensity_augment_3d(ema, rng, mode="2D", contrast_factor=0.1,
                                       brightness_factor=0.1)
        if self.ema_mask:
            ema = ema * gen_mask_3d(ema.shape, rng)
        if self.ema_flip:
            rule = rng.integers(0, 2, size=4).astype(np.float32)
            ema = simple_augment_3d(ema, rule.astype(np.uint8))
        else:
            rule = np.zeros(4, np.float32)
        return np.ascontiguousarray(ema, np.float32)[..., None], rule

    def _augs_mix(self, imgs, lb, rng):
        if rng.random() > 0.5:  # flips
            rule = rng.integers(0, 2, size=4).astype(np.uint8)
            imgs = simple_augment_3d(imgs, rule).copy()
            lb = simple_augment_3d(lb, rule).copy()
        if rng.random() > 0.5:  # rot90 in y, x
            k = int(rng.integers(0, 4))
            imgs = np.rot90(imgs, k, axes=(1, 2)).copy()
            lb = np.rot90(lb, k, axes=(1, 2)).copy()
        if rng.random() < 0.5:  # one elastic field for every slice, 0 outside
            mx, my = elastic_maps(rng, *imgs.shape[1:], alpha=16.0, sigma=4.0)
            imgs = dw.remap_bilinear(torch.from_numpy(np.ascontiguousarray(imgs)), mx, my,
                                     "constant").numpy()
            lb = dw.remap_nearest(torch.from_numpy(np.ascontiguousarray(lb)), mx, my,
                                  "constant").numpy()
        if rng.random() < 0.5:  # grayscale
            imgs = intensity_augment_3d(imgs, rng)
        if rng.random() < 0.2:  # EM artifacts: missing sections or misalignment
            if rng.random() < 0.5:
                imgs = missing_section_augment(imgs, rng)
            else:
                imgs, lb = misalign_augment(imgs, lb, rng)
        return imgs, lb


def convert_consistency_flip_3d_rule4(emb_bdhwc: torch.Tensor,
                                      rules_b4: torch.Tensor) -> torch.Tensor:
    """Un-flip per-sample EMA embeddings (B, D, H, W, C) by their 4-bit rules
    (z, x, y, xy-transpose; H == W): the transpose, then the y-, x- and
    z-flips, each where the sample's bit is set. The result has the
    input's strides, as ``consistency.convert_consistency_flip``'s."""
    r = rules_b4.bool()

    def bit(i):
        return r[:, i, None, None, None, None]

    e = torch.where(~bit(3), emb_bdhwc, emb_bdhwc.transpose(2, 3))
    e = torch.where(bit(2), e.flip(2), e)
    e = torch.where(bit(1), e.flip(3), e)
    return torch.where(bit(0), e.flip(1), e)


def synthesize_volume(d=40, h=256, w=256, n_cells=40, seed=0):
    """Synthetic EM-like volume: random 3D Voronoi cells (z scaled by 4) with
    dark noisy boundaries. Returns (raw uint8, label int64), both (d, h, w)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.integers(0, d, n_cells), rng.integers(0, h, n_cells),
                    rng.integers(0, w, n_cells)], axis=1).astype(np.float32)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([zz.reshape(-1) * 4.0, yy.reshape(-1), xx.reshape(-1)],
                      axis=1).astype(np.float32)
    pts[:, 0] *= 4.0
    _, idx = cKDTree(pts).query(coords, workers=-1)
    label = (idx.reshape(d, h, w) + 1).astype(np.int64)

    raw = np.full((d, h, w), 180.0)
    boundary = np.zeros((d, h, w), bool)
    for axis in range(3):
        hi = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi[axis] = slice(1, None)
        lo[axis] = slice(0, -1)
        boundary[tuple(hi)] |= label[tuple(hi)] != label[tuple(lo)]
    raw[boundary] = 60.0
    raw += rng.normal(0, 15, raw.shape)
    return np.clip(raw, 0, 255).astype(np.uint8), label


def label_affinities(label: np.ndarray, seed: int = 0) -> np.ndarray:
    """A noisy affinity canvas (12, D, H, W) float32 from a label volume,
    for exercising the decoders on real segment counts: 1 where a voxel and
    its shift-table neighbour share a label, 0 across a boundary or off the
    volume; then squeezed into [0.1, 0.9] with seeded Gaussian noise
    (sigma 0.15), clipped to [0, 1], so the decoders have ties to break."""
    from ..ops.offsets import offsets_3d

    affs = np.zeros((12,) + label.shape, np.float32)
    for k, off in enumerate(offsets_3d()):
        axis, s = int(np.nonzero(off)[0][0]), -sum(off)
        hi = [slice(None)] * 3
        lo = [slice(None)] * 3
        hi[axis], lo[axis] = slice(s, None), slice(0, label.shape[axis] - s)
        affs[k][tuple(hi)] = label[tuple(hi)] == label[tuple(lo)]
    noise = np.random.default_rng(seed).normal(0, 0.15, affs.shape)
    return np.clip(0.1 + 0.8 * affs + noise, 0, 1).astype(np.float32)
