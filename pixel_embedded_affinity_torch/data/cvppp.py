"""CVPPP A1 data: the host training sampler and its targets, and the
padded, ImageNet-normalised validation and test images (HWC numpy).

The on-disk layout is the reference's: ``data_folder/train/plantXXX_rgb.png``
and ``_label.png``, ``data_folder/valid_set/<name>.txt``, and
``data_folder/test/plantXXX_{rgb,fg}.png``. Images are reflect-padded by
(7, 7) rows and (22, 22) columns, 530x500 -> 544x544; labels and FG masks
are zero-padded. PNGs are read with cv2, imported where it is used;
:func:`decoded_split` takes the files as cv2 decodes them in their place.

:class:`CVPPPTrain` is the JAX package's host sampler: a random training
image, padded, flipped and RandomResizedCrop'd to ``size``, normalised;
then with ``light`` (``data.device_gt``) the image and labels alone (the
train step builds the targets on the device), plus the EMA view and its
rule unless ``device_ema``; without ``light`` every target on the host
(:func:`build_cvppp_targets`). Its draws come from a
``np.random.Generator`` in the JAX sampler's order, and it warps without
cv2 (:mod:`.augment2d`).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.affinity_np import gen_affs, label_pyramid, weight_binary_ratio
from ..ops.offsets import multi_offset
from . import consistency as C
from .augment2d import random_flips, random_resized_crop
from .consistency import normalize_imagenet

PAD = ((7, 7), (22, 22))


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


def host_ema_view(image_hwc, label, rng, *, normalized: bool, ema_noise=False,
                ema_blur=False, ema_intensity=True, ema_mask=True, ema_flip=True):
    """(EMA view, rule (3,) float32) of one image, the host chain: from
    the [0, 1] image (de-normalised when ``normalized``), noise, blur,
    intensity, foreground-mean squares, normalised again, then the flip."""
    ema = (C.denormalize_imagenet(image_hwc) if normalized else image_hwc).copy()
    if ema_noise:
        ema = C.add_gauss_noise(ema, rng)
    if ema_blur:
        ema = C.add_gauss_blur(ema, rng)
    if ema_intensity:
        ema = C.add_intensity(ema, rng)
    if ema_mask:
        ema = C.add_mask(ema, (label != 0).astype(np.uint8), rng)
    if normalized:
        ema = normalize_imagenet(ema)
    if ema_flip:
        rule = C.flip_ema_rule(rng)
        ema = C.simple_augment(ema, rule.astype(np.uint8))
    else:
        rule = np.zeros(3, np.float32)
    return np.ascontiguousarray(ema, np.float32), rule


def build_cvppp_light(image_hwc, label, rng, ema_noise=False, ema_blur=False,
                      ema_intensity=True, ema_mask=True, ema_flip=True) -> dict:
    """The sample for targets built on the device: image, EMA view, labels
    and the view's rule."""
    ema, rule = host_ema_view(image_hwc, label, rng, normalized=True, ema_noise=ema_noise,
                            ema_blur=ema_blur, ema_intensity=ema_intensity,
                            ema_mask=ema_mask, ema_flip=ema_flip)
    return {"image": np.ascontiguousarray(image_hwc, np.float32), "ema_image": ema,
            "seg": label.astype(np.int32), "rules": rule}


def host_targets_2d(label, offsets, nb_half: int, separate_weight: bool = True) -> dict:
    """The 2D targets of one label map, as the JAX package's host samplers
    build them: ``affs`` and ``mask`` (K, H, W) of ``gen_affs(padding=
    True)``, ``wmap`` (one weight map per offset with
    ``separate_weight``), and ``down1..4``, the pyramid levels' targets,
    weights and masks stacked along channels with the first
    ``nb_half * (4 - level)`` offsets."""
    def weights_for(a):
        if separate_weight:
            return np.stack([weight_binary_ratio(a[i]) for i in range(a.shape[0])])
        return weight_binary_ratio(a)

    affs, mask = gen_affs(label, offsets, ignore=False, padding=True)
    out = {"affs": affs, "wmap": weights_for(affs), "mask": mask}
    for lvl, lab_d in enumerate(label_pyramid(label, num_levels=4)):
        n_off = nb_half * (4 - lvl)
        a, m = gen_affs(lab_d, offsets[:n_off], ignore=False, padding=True)
        out[f"down{lvl + 1}"] = np.concatenate([a, weights_for(a), m.astype(np.float32)],
                                               axis=0)
    return out


def build_cvppp_targets(image_hwc, label, offsets, nb_half, separate_weight, rng,
                        ema_noise=False, ema_blur=False, ema_intensity=True, ema_mask=True,
                        ema_flip=True) -> dict:
    """Every target of a sample built on the host, and the EMA view."""
    out = host_targets_2d(label, offsets, nb_half, separate_weight)
    ema, rule = host_ema_view(image_hwc, label, rng, normalized=True, ema_noise=ema_noise,
                            ema_blur=ema_blur, ema_intensity=ema_intensity,
                            ema_mask=ema_mask, ema_flip=ema_flip)
    return {"image": np.ascontiguousarray(image_hwc, np.float32), **out,
            "seg": label.astype(np.int32), "ema_image": ema, "rules": rule}


class CVPPPTrain:
    """The training sampler: ``sample(rng)`` -> one sample dict (see the
    module's docstring). ``pairs``, the training pairs as
    :func:`decoded_split` gives them (image float32 RGB in [0, 1], label
    int32), in sorted name order, stands in for the files."""

    def __init__(self, data_folder: str = "", size: int = 544, shifts=(1, 3, 5, 9, 27),
                 neighbor: int = 4, padding: bool = True, separate_weight: bool = True,
                 valid_set: str = "local_20_1", ema_noise: bool = False,
                 ema_blur: bool = False, ema_intensity: bool = True, ema_mask: bool = True,
                 ema_flip: bool = True, light: bool = False, device_ema: bool = False,
                 seed: int = 555, pairs=None):
        self.dir = os.path.join(data_folder, "train")
        self.size, self.padding = size, padding
        self.offsets = multi_offset(list(shifts), neighbor=neighbor)
        self.nb_half = neighbor // 2
        self.separate_weight = separate_weight
        self.ema = dict(ema_noise=ema_noise, ema_blur=ema_blur, ema_intensity=ema_intensity,
                        ema_mask=ema_mask, ema_flip=ema_flip)
        self.light, self.device_ema = light, device_ema
        self.rng = np.random.default_rng(seed)
        self.pairs = pairs
        self.names = split_names(data_folder, valid_set)[0] if pairs is None else None

    def __len__(self):
        return len(self.pairs if self.pairs is not None else self.names)

    def _load(self, k: int):
        if self.pairs is not None:
            img, label = self.pairs[k]
            return np.asarray(img, np.float32), np.asarray(label).astype(np.int32)
        name = self.names[k]
        return (_read_rgb(os.path.join(self.dir, name + "_rgb.png")),
                _read_gray(os.path.join(self.dir, name + "_label.png")).astype(np.int32))

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng or self.rng
        img, label = self._load(int(rng.integers(0, len(self))))
        if self.padding:
            img = np.pad(img, PAD + ((0, 0),), mode="reflect")
            label = np.pad(label, PAD, mode="constant")
        img, label = random_flips(img, label, rng)
        img, label = random_resized_crop(img, label, self.size, rng, scale=(0.7, 1.0))
        image = normalize_imagenet(img)
        if self.light:
            if self.device_ema:
                return {"image": np.ascontiguousarray(image, np.float32),
                        "seg": label.astype(np.int32)}
            return build_cvppp_light(image, label, rng, **self.ema)
        return build_cvppp_targets(image, label, self.offsets, self.nb_half,
                                   self.separate_weight, rng, **self.ema)


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


def synthesize(data_folder: str, n_train: int = 12, h: int = 530, w: int = 500,
               n_valid: int = 3, n_test: int = 0, seed: int = 0):
    """Write a synthetic CVPPP-layout dataset (leaf-like blobs)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(data_folder, "train"), exist_ok=True)
    os.makedirs(os.path.join(data_folder, "valid_set"), exist_ok=True)
    if n_test:
        os.makedirs(os.path.join(data_folder, "test"), exist_ok=True)
    names = []
    for i in range(n_train + n_test):
        split = "train" if i < n_train else "test"
        name = f"plant{i:03d}"
        if split == "train":
            names.append(name)
        label = np.zeros((h, w), np.uint8)
        img = rng.normal(0.1, 0.03, (h, w, 3)).astype(np.float32)
        n_leaves = int(rng.integers(4, 12))
        cy, cx = h // 2, w // 2
        m = min(h, w)
        for leaf in range(1, n_leaves + 1):
            ang = rng.uniform(0, 2 * np.pi)
            dist = rng.uniform(m / 12, max(m / 2 - m / 8, m / 12 + 1))
            ly = int(cy + dist * np.sin(ang))
            lx = int(cx + dist * np.cos(ang))
            ax_lo = max(m // 20, 3)
            axes = (int(rng.integers(ax_lo, ax_lo * 3)),
                    int(rng.integers(max(ax_lo // 2, 2), ax_lo * 2)))
            rot = int(rng.integers(0, 180))
            cv2.ellipse(label, (lx, ly), axes, rot, 0, 360, int(leaf), -1)
        green = rng.uniform(0.4, 0.8)
        img[label > 0] = np.stack([
            np.full((label > 0).sum(), 0.15),
            np.full((label > 0).sum(), green),
            np.full((label > 0).sum(), 0.1)], axis=-1)
        img += rng.normal(0, 0.02, img.shape)
        img = np.clip(img, 0, 1)
        cv2.imwrite(os.path.join(data_folder, split, name + "_rgb.png"),
                    (img[:, :, ::-1] * 255).astype(np.uint8))
        if split == "train":
            cv2.imwrite(os.path.join(data_folder, split, name + "_label.png"),
                        label)
        fg = (label > 0).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(data_folder, split, name + "_fg.png"), fg)
    with open(os.path.join(data_folder, "valid_set", "local_20_1.txt"), "w") as f:
        for n in names[:n_valid]:
            f.write(n + "\n")
    return names
