"""BBBC039V1 nuclei data: the JAX package's ``data/bbbc.py`` for training
(the host sampler ``BBBCTrain``), serving and validation, and synthetic
nuclei made in memory.

The on-disk layout is the reference's: ``images/<name>.tif`` (16-bit
grayscale), ``masks_instance/<name>.png`` (instance ids) and
``metadata/{training,validation,test}.txt`` (one ``<name>.png`` per line).
Images are min-max normalised to [0, 1] when read; files are read with cv2,
imported where it is used; :func:`decoded_pairs` takes the files as cv2
decodes them in their place. ``synthesize_nuclei`` makes (image, label) pairs
with no file and no cv2, the same kind of blobs as the JAX package's
``synthesize``; the datasets and the device sampler
(:mod:`.device_data`) take such pairs in place of the files.

:class:`BBBCTrain` is the JAX package's host sampler: a random training
image reflect-padded, a random (size + 2 padding)^2 crop, at p = 0.8 the
augmentation mix (flips, rotation, rescale, elastic, grayscale, each at
0.5), the centre size^2, repeated to 3 channels; then, as CVPPP's, the
labels alone with ``light``, the EMA view unless ``device_ema``, or every
target on the host. Draws from a ``np.random.Generator`` in the JAX
sampler's order; warps without cv2 (:mod:`.augment2d`).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.affinity_np import gen_affs, weight_binary_ratio
from ..ops.offsets import multi_offset
from .augment2d import (center_crop_pad, elastic_deform, random_flips, random_grayscale_adjust,
                        random_rescale, random_rotate)

SPLITS = {"train": "training.txt", "validation": "validation.txt", "test": "test.txt"}
# the validation geometry: each image constant-padded to 704x704, then the
# window [92:-92, 4:-4], 520x696 (the reference's Validation)
VALID_SIDE, VALID_CROP = 704, (92, 4)


def split_names(data_folder: str, mode: str = "train") -> list[str]:
    """The image names of a split, as listed in ``metadata/``."""
    with open(os.path.join(data_folder, "metadata", SPLITS[mode])) as f:
        return [x.strip()[:-4] for x in f if x.strip()]


def decoded_pair(img: np.ndarray, label: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An image and its instance mask as cv2 decodes them
    (``cv2.IMREAD_UNCHANGED``) -> (image float32 (H, W) min-max normalised
    to [0, 1], label int32)."""
    img = img.astype(np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
    if label.ndim == 3:
        label = label[..., 0]
    return img, label.astype(np.int32)


def load_pair(data_folder: str, name: str) -> tuple[np.ndarray, np.ndarray]:
    """(image float32 (H, W) min-max normalised to [0, 1], label int32)."""
    import cv2

    decoded = []
    for path in (os.path.join(data_folder, "images", name + ".tif"),
                 os.path.join(data_folder, "masks_instance", name + ".png")):
        a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if a is None:
            raise FileNotFoundError(path)
        decoded.append(a)
    return decoded_pair(*decoded)


def load_pairs(data_folder: str, mode: str = "train") -> list:
    return [load_pair(data_folder, n) for n in split_names(data_folder, mode)]


def decoded_pairs(names, images, labels, split) -> list:
    """The pairs of a split from the files as cv2 decodes them:
    ``images[i]`` is ``names[i]``'s ``images/<name>.tif``, ``labels[i]`` its
    ``masks_instance/<name>.png``, ``split`` the names that
    ``metadata/<split>.txt`` lists, in its order; as :func:`load_pairs`."""
    index = {str(n): i for i, n in enumerate(names)}
    return [decoded_pair(np.asarray(images[index[str(n)]]), np.asarray(labels[index[str(n)]]))
            for n in split]


def build_bbbc_targets(image_hwc, label, offsets, nb_half, separate_weight, rng,
                       ema_intensity=True, ema_mask=True, ema_flip=True) -> dict:
    """Every target of a sample built on the host, and the EMA view (on the
    [0, 1] image: BBBC is not ImageNet-normalised)."""
    from .cvppp import host_ema_view, host_targets_2d

    out = host_targets_2d(label, offsets, nb_half, separate_weight)
    ema, rule = host_ema_view(image_hwc, label, rng, normalized=False,
                            ema_intensity=ema_intensity, ema_mask=ema_mask, ema_flip=ema_flip)
    return {"image": np.ascontiguousarray(image_hwc, np.float32), **out,
            "seg": label.astype(np.int32), "ema_image": ema, "rules": rule}


class BBBCTrain:
    """The training sampler: ``sample(rng)`` -> one sample dict (see the
    module's docstring), drawn from ``mode``'s split (train, validation
    or test). ``pairs``, the split's (image, label) as :func:`decoded_pairs`
    gives them, stands in for the files."""

    def __init__(self, data_folder: str = "", size: int = 256, padding: int = 30,
                 shifts=(1, 3, 5, 9, 11), neighbor: int = 4, separate_weight: bool = True,
                 mode: str = "train", aug_prob: float = 0.8, ema_intensity: bool = True,
                 ema_mask: bool = True, ema_flip: bool = True, light: bool = False,
                 device_ema: bool = False, seed: int = 555, pairs=None):
        self.data_folder = data_folder
        self.size, self.padding = size, padding
        self.offsets = multi_offset(list(shifts), neighbor=neighbor)
        self.nb_half = neighbor // 2
        self.separate_weight = separate_weight
        self.aug_prob = aug_prob
        self.ema = dict(ema_intensity=ema_intensity, ema_mask=ema_mask, ema_flip=ema_flip)
        self.light, self.device_ema = light, device_ema
        self.rng = np.random.default_rng(seed)
        self.pairs = pairs
        self.names = split_names(data_folder, mode) if pairs is None else None

    def __len__(self):
        return len(self.pairs if self.pairs is not None else self.names)

    def _load(self, k: int):
        if self.pairs is not None:
            img, label = self.pairs[k]
            return np.asarray(img, np.float32), np.asarray(label).astype(np.int32)
        return load_pair(self.data_folder, self.names[k])

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng or self.rng
        img, label = self._load(int(rng.integers(0, len(self))))
        pad = self.padding
        img = np.pad(img, pad, mode="reflect")
        label = np.pad(label, pad, mode="reflect")
        crop = self.size + 2 * pad
        rx = int(rng.integers(0, img.shape[0] - crop + 1))
        ry = int(rng.integers(0, img.shape[1] - crop + 1))
        img, label = img[rx:rx + crop, ry:ry + crop], label[rx:rx + crop, ry:ry + crop]
        if rng.random() < self.aug_prob:
            if rng.random() > 0.5:
                img, label = random_flips(img, label, rng)
            if rng.random() > 0.5:
                img, label = random_rotate(img, label, rng)
            if rng.random() < 0.5:
                img, label = random_rescale(img, label, rng)
            if rng.random() < 0.5:
                img, label = elastic_deform(img, label, rng, alpha=16, sigma=4.0)
            if rng.random() < 0.5:
                img = random_grayscale_adjust(img, rng)
        img = center_crop_pad(img, self.size, self.size)
        label = center_crop_pad(label, self.size, self.size)
        image = np.repeat(img[..., None], 3, axis=-1).astype(np.float32)
        if self.light:
            if self.device_ema:
                return {"image": np.ascontiguousarray(image), "seg": label.astype(np.int32)}
            from .cvppp import host_ema_view

            ema, rule = host_ema_view(image, label, rng, normalized=False, **self.ema)
            return {"image": np.ascontiguousarray(image), "ema_image": ema,
                    "seg": label.astype(np.int32), "rules": rule}
        return build_bbbc_targets(image, label, self.offsets, self.nb_half,
                                  self.separate_weight, rng, **self.ema)


class BBBCValidation:
    """Validation (or test) images with their targets: ``{image (520, 696,
    3) float32 in [0, 1], affs, wmap (K, H, W) float32, mask (K, H, W)
    uint8, seg (H, W) int32}``, the grayscale image repeated to 3
    channels, the targets of ``gen_affs(padding=True)`` with one weight map
    per channel (``separate_weight``) or one over all. ``pairs``, a list
    of (image, label) as :func:`load_pair` gives them, stands in for the
    files (cv2 is read only when they are)."""

    def __init__(self, data_folder: str = "", shifts=(1, 3, 5, 9, 11), neighbor: int = 4,
                 mode: str = "validation", separate_weight: bool = True, pairs=None):
        self.data_folder = data_folder
        self.pairs = pairs
        self.names = split_names(data_folder, mode) if pairs is None else None
        self.offsets = multi_offset(list(shifts), neighbor=neighbor)
        self.separate_weight = separate_weight

    def __len__(self):
        return len(self.pairs if self.pairs is not None else self.names)

    def __getitem__(self, idx) -> dict:
        img, label = (self.pairs[idx] if self.pairs is not None
                      else load_pair(self.data_folder, self.names[idx]))
        ph, pw = VALID_SIDE - img.shape[0], VALID_SIDE - img.shape[1]
        pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
        (cy, cx) = VALID_CROP
        img = np.pad(img, pads)[cy:-cy, cx:-cx]
        label = np.pad(label, pads)[cy:-cy, cx:-cx]
        affs, mask = gen_affs(label, self.offsets, ignore=False, padding=True)
        wmap = (np.stack([weight_binary_ratio(a) for a in affs]) if self.separate_weight
                else weight_binary_ratio(affs))
        return {"image": np.repeat(img[..., None], 3, axis=-1).astype(np.float32),
                "affs": affs, "wmap": wmap, "mask": mask, "seg": label.astype(np.int32)}


def convert_mask_to_instances(mask: np.ndarray, min_size: int = 25) -> np.ndarray:
    """A foreground mask -> instance labels 1..N: its connected components,
    those below ``min_size`` pixels dropped."""
    from scipy import ndimage

    lab, n = ndimage.label(mask > 0)
    if n == 0:
        return lab.astype(np.int32)
    sizes = np.bincount(lab.reshape(-1))
    keep = np.arange(sizes.size)
    keep[sizes < min_size] = 0
    lab = keep[lab]
    uid = np.unique(lab)
    uid = uid[uid > 0]
    lut = np.zeros(int(lab.max()) + 1, np.int32)
    lut[uid] = np.arange(1, len(uid) + 1)
    return lut[lab]


def synthesize_nuclei(n: int, h: int = 520, w: int = 696, seed: int = 0) -> list:
    """``n`` synthetic BBBC-like (image, label) pairs, as :func:`load_pair`
    returns them: 30-80 elliptic nuclei of 5-14 pixel semi-axes (ids in
    drawing order, later ones over earlier ones) on a 16-bit background of
    200 +- 20, nuclei 600 +- 50 brighter, min-max normalised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pairs = []
    for _ in range(n):
        label = np.zeros((h, w), np.int32)
        for nid in range(1, int(rng.integers(30, 80)) + 1):
            cy, cx = rng.integers(15, h - 15), rng.integers(15, w - 15)
            ay, ax = rng.integers(5, 14, size=2)
            rot = np.deg2rad(rng.integers(0, 180))
            dy, dx = yy - cy, xx - cx
            u = dx * np.cos(rot) + dy * np.sin(rot)
            v = -dx * np.sin(rot) + dy * np.cos(rot)
            label[(u / ax) ** 2 + (v / ay) ** 2 <= 1] = nid
        img = rng.normal(200, 20, (h, w)).astype(np.float32)
        fg = label > 0
        img[fg] += 600 + rng.normal(0, 50, int(fg.sum()))
        img = np.clip(img, 0, 65535).astype(np.uint16).astype(np.float32)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        pairs.append((img, label))
    return pairs


def synthesize(data_folder: str, n_train: int = 8, n_valid: int = 2,
               n_test: int = 2, h: int = 520, w: int = 696, seed: int = 0):
    """Synthetic BBBC-layout dataset (nuclei-like blobs, TIFF + PNG labels)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(data_folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(data_folder, "masks_instance"), exist_ok=True)
    os.makedirs(os.path.join(data_folder, "metadata"), exist_ok=True)
    splits = {"training.txt": [], "validation.txt": [], "test.txt": []}
    total = n_train + n_valid + n_test
    for i in range(total):
        name = f"IXM_{i:03d}"
        label = np.zeros((h, w), np.uint16)
        img = rng.normal(200, 20, (h, w)).astype(np.float32)
        n_nuc = int(rng.integers(30, 80))
        for nid in range(1, n_nuc + 1):
            cy = int(rng.integers(15, h - 15))
            cx = int(rng.integers(15, w - 15))
            axes = (int(rng.integers(5, 14)), int(rng.integers(5, 14)))
            rot = int(rng.integers(0, 180))
            cv2.ellipse(label, (cx, cy), axes, rot, 0, 360, int(nid), -1)
        img[label > 0] += 600 + rng.normal(0, 50, int((label > 0).sum()))
        cv2.imwrite(os.path.join(data_folder, "images", name + ".tif"),
                    img.astype(np.uint16))
        cv2.imwrite(os.path.join(data_folder, "masks_instance", name + ".png"),
                    label)
        if i < n_train:
            splits["training.txt"].append(name)
        elif i < n_train + n_valid:
            splits["validation.txt"].append(name)
        else:
            splits["test.txt"].append(name)
    for fname, names in splits.items():
        with open(os.path.join(data_folder, "metadata", fname), "w") as f:
            for n in names:
                f.write(n + ".png\n")
