"""CVPPP A1 serving data: padded, ImageNet-normalised images (HWC numpy).

The on-disk layout is the reference's: ``data_folder/train/plantXXX_rgb.png``
and ``_label.png``, ``data_folder/valid_set/<name>.txt``, and
``data_folder/test/plantXXX_{rgb,fg}.png``. Images are reflect-padded by
(7, 7) rows and (22, 22) columns, 530x500 -> 544x544; labels and FG masks
are zero-padded. PNGs are read with cv2, imported where it is used;
:func:`decoded_split` takes the files as cv2 decodes them in their place.
"""

from __future__ import annotations

import os

import numpy as np

from .consistency import IMAGENET_MEAN, IMAGENET_STD

PAD = ((7, 7), (22, 22))


def normalize_imagenet(img_hwc: np.ndarray) -> np.ndarray:
    return (img_hwc.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD


def rgb_from_bgr(bgr: np.ndarray) -> np.ndarray:
    """A colour PNG as cv2 decodes it (BGR uint8) -> RGB float32 in [0, 1]."""
    return bgr[:, :, ::-1].astype(np.float32) / 255.0


def _plane(a: np.ndarray) -> np.ndarray:
    return a[..., 0] if a.ndim == 3 else a


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return rgb_from_bgr(img)


def _read_gray(path: str) -> np.ndarray:
    import cv2

    a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if a is None:
        raise FileNotFoundError(path)
    return _plane(a)


def split(names, valid_names) -> tuple[list, list]:
    """(training names, validation names): training, the names not in
    ``valid_names``, sorted; validation, ``valid_names`` in their order."""
    valid = [str(n) for n in valid_names]
    return sorted(str(n) for n in names if str(n) not in valid), valid


def split_names(data_folder: str, valid_set: str = "local_20_1") -> tuple[list, list]:
    """(training names, validation names) of ``train/``'s ``plantXXX``: the
    validation names listed in ``valid_set/<valid_set>.txt``, or without
    that file the first fifth (the JAX package's rule); training, the
    others (:func:`split`)."""
    names = sorted({f[:8] for f in os.listdir(os.path.join(data_folder, "train"))
                    if "rgb" in f})
    valid_file = os.path.join(data_folder, "valid_set", valid_set + ".txt")
    if os.path.exists(valid_file):
        with open(valid_file) as f:
            valid = [x.strip() for x in f if x.strip()]
    else:
        valid = names[: max(1, len(names) // 5)]
    return split(names, valid)


def decoded_split(names, bgr_images, labels, valid_names) -> tuple[list, list]:
    """The files of ``train/`` as cv2 decodes them -> (training pairs,
    validation pairs), each pair (image float32 (H, W, 3) RGB in [0, 1],
    label int32) as the readers make it: ``bgr_images[i]`` is ``names[i]``'s
    ``_rgb.png`` (``cv2.IMREAD_COLOR``), ``labels[i]`` its ``_label.png``
    (``cv2.IMREAD_UNCHANGED``), ``valid_names`` the lines of
    ``valid_set/<valid_set>.txt``; split as :func:`split_names` splits."""
    pairs = {str(n): (rgb_from_bgr(np.asarray(b)), _plane(np.asarray(lab)).astype(np.int32))
             for n, b, lab in zip(names, bgr_images, labels)}
    return tuple([pairs[n] for n in part] for part in split(pairs, valid_names))


class CVPPPValidation:
    """Validation images with GT labels: ``{image, seg, name}``. ``pairs``,
    a list of (image, label) as :func:`decoded_split` gives them, stands in
    for the files (cv2 is read only when they are; ``name`` is then None)."""

    def __init__(self, data_folder: str = "", valid_set: str = "local_20_1",
                 padding: bool = True, pairs=None):
        self.dir = os.path.join(data_folder, "train")
        self.padding = padding
        self.pairs = pairs
        self.names = split_names(data_folder, valid_set)[1] if pairs is None else None

    def __len__(self):
        return len(self.pairs if self.pairs is not None else self.names)

    def __getitem__(self, idx) -> dict:
        if self.pairs is not None:
            (img, label), name = self.pairs[idx], None
        else:
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
