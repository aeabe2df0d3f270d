"""CVPPP A1 serving data: padded, ImageNet-normalised images (HWC numpy).

The on-disk layout is the reference's: ``data_folder/train/plantXXX_rgb.png``
and ``_label.png``, ``data_folder/valid_set/<name>.txt``, and
``data_folder/test/plantXXX_{rgb,fg}.png``. Images are reflect-padded by
(7, 7) rows and (22, 22) columns, 530x500 -> 544x544; labels and FG masks
are zero-padded. PNGs are read with cv2, imported where it is used.
"""

from __future__ import annotations

import os

import numpy as np

from .consistency import IMAGENET_MEAN, IMAGENET_STD

PAD = ((7, 7), (22, 22))


def normalize_imagenet(img_hwc: np.ndarray) -> np.ndarray:
    return (img_hwc.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].astype(np.float32) / 255.0  # BGR -> RGB


def _read_gray(path: str) -> np.ndarray:
    import cv2

    a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if a is None:
        raise FileNotFoundError(path)
    return a[..., 0] if a.ndim == 3 else a


class CVPPPValidation:
    """Validation images with GT labels: ``{image, seg, name}``."""

    def __init__(self, data_folder: str, valid_set: str = "local_20_1",
                 padding: bool = True):
        self.dir = os.path.join(data_folder, "train")
        self.padding = padding
        valid_file = os.path.join(data_folder, "valid_set", valid_set + ".txt")
        if os.path.exists(valid_file):
            with open(valid_file) as f:
                self.names = [x.strip() for x in f if x.strip()]
        else:  # the JAX package's rule: the first fifth of the train names
            names = sorted({f[:8] for f in os.listdir(self.dir) if "rgb" in f})
            self.names = names[: max(1, len(names) // 5)]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx) -> dict:
        name = self.names[idx]
        img = _read_rgb(os.path.join(self.dir, name + "_rgb.png"))
        label = _read_gray(os.path.join(self.dir, name + "_label.png")).astype(np.int32)
        if self.padding:
            img = np.pad(img, PAD + ((0, 0),), mode="reflect")
            label = np.pad(label, PAD, mode="constant")
        return {"image": np.ascontiguousarray(normalize_imagenet(img)),
                "seg": label, "name": name}


class CVPPPTest:
    """Test images, no labels; the FG mask is given: ``{image, fg, name}``."""

    def __init__(self, data_folder: str, padding: bool = True):
        self.dir = os.path.join(data_folder, "test")
        self.names = sorted({f[:8] for f in os.listdir(self.dir) if "rgb" in f},
                            key=lambda x: int(x[5:8]))
        self.padding = padding

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx) -> dict:
        name = self.names[idx]
        img = _read_rgb(os.path.join(self.dir, name + "_rgb.png"))
        fg = (_read_gray(os.path.join(self.dir, name + "_fg.png")) > 0).astype(np.uint8)
        if self.padding:
            img = np.pad(img, PAD + ((0, 0),), mode="reflect")
            fg = np.pad(fg, PAD, mode="constant")
        return {"image": np.ascontiguousarray(normalize_imagenet(img)),
                "fg": fg, "name": name}
