"""BBBC039V1 nuclei data: the JAX package's ``data/bbbc.py`` for serving
and validation, and synthetic nuclei made in memory.

The on-disk layout is the reference's: ``images/<name>.tif`` (16-bit
grayscale), ``masks_instance/<name>.png`` (instance ids) and
``metadata/{training,validation,test}.txt`` (one ``<name>.png`` per line).
Images are min-max normalised to [0, 1] when read; files are read with cv2,
imported where it is used; :func:`decoded_pairs` takes the files as cv2
decodes them in their place. ``synthesize_nuclei`` makes (image, label) pairs
with no file and no cv2, the same kind of blobs as the JAX package's
``synthesize``; the datasets and the device sampler
(:mod:`.device_data`) take such pairs in place of the files.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.affinity_np import gen_affs, weight_binary_ratio
from ..ops.offsets import multi_offset

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


class BBBCValidation:
    """Validation (or test) images with their targets: ``{image (520, 696,
    3) float32 in [0, 1], affs, wmap (K, H, W) float32, mask (K, H, W)
    uint8, seg (H, W) int32}``, the grayscale image repeated to 3
    channels, the targets of ``gen_affs(padding=True)`` with one weight map
    per channel. ``pairs``, a list of (image, label) as :func:`load_pair`
    gives them, stands in for the files (cv2 is read only when they are)."""

    def __init__(self, data_folder: str = "", shifts=(1, 3, 5, 9, 11), neighbor: int = 4,
                 mode: str = "validation", pairs=None):
        self.data_folder = data_folder
        self.pairs = pairs
        self.names = split_names(data_folder, mode) if pairs is None else None
        self.offsets = multi_offset(list(shifts), neighbor=neighbor)

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
        wmap = np.stack([weight_binary_ratio(a) for a in affs])
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
