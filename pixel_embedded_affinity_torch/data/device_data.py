"""Device-resident training data for the three pipelines: the port of the
JAX package's ``data/device_data.py``.

The training set is packed once on the host and uploaded once; each step
then picks, crops and augments its batch on the device, with no host copy
of image data. The draws of a batch come from a CPU ``torch.Generator``
seeded by (seed, step) (:func:`sampler_generator`), so the box, the gates
and the shifts are known on the host, drawing costs no device sync, and a
resumed run draws what an uninterrupted one drew; noise fields (elastic
displacements, per-slice intensities, noise-filled sections) come from a
generator on the data's device seeded from it. The draws are not the JAX
package's bits: the tests hold each link to JAX's at fixed parameters and
the samplers by their contracts and gate rates. Where JAX computes every
link and selects (``jnp.where``), the port runs only the links that were
drawn: the same distribution, less work.

CVPPP (``sample_cvppp``): uint8 RGB images and int32 labels, reflect- and
zero-padded to 544x544 (:func:`pack_cvppp_arrays`); per sample an image,
a horizontal and a vertical flip (each at 0.5), torchvision's
RandomResizedCrop box (scale 0.7-1, aspect 3/4-4/3, 10 attempts, then the
aspect-clamped centre) resized to ``out`` with cv2's bilinear (images,
values still on 0-255) and nearest (labels) conventions, then /255 and
the ImageNet normalisation.

BBBC039V1 (``sample_bbbc``): float32 images padded once (numpy 'reflect',
``data.bbbc_padding``); per sample (size + 2 padding)^2 windows, the
reference's augmentation chain on ``AUG_PROB`` (0.8) of the samples, each
link gated at 0.5 as the reference's augs_mix gates them: flips (each axis
at 0.5), rotation by an angle uniform in [0, 360) with a zero fill,
rescaling by a factor uniform in [0.8, 1.2), an elastic warp (alpha 16,
sigma 4, zero fill) and a grayscale jitter (contrast, brightness, gamma);
the centre size^2.

AC3/AC4 (``sample_ac3ac4``): the uint8 volume and int32 labels
(:func:`load_ac3ac4_arrays`: the first ``train_split`` slices, borders
widened); per sample a (cz, cy + 2 padding, cx + 2 padding) crop, /255,
on ``AC3AC4_AUG_PROB`` (0.5) of the samples the reference's _augs_mix (the 4-bit
flip at 0.5, a rot90 in xy at 0.5, one elastic field for every slice at
0.5, the intensity jitter at 0.5, and at 0.2 an EM artefact: missing
sections or a misalignment, 0.5 each), then the centre crop. Labels follow
the geometric links with nearest sampling.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ops.affinity_np import seg_widen_border
from . import device_warp as dw
from .ac3ac4 import read_volume
from .bbbc import load_pairs
from .consistency import imagenet_stats
from .cvppp import PAD, _read_gray, _read_rgb, split_names

# distinct from the EMA view's (seed, step) stream, as the JAX loop folds
# 55991 into its sampler key
_STREAM = 55991
# the share of BBBC samples that go through the augmentation chain
AUG_PROB = 0.8
# the share of AC3/AC4 samples that go through _augs_mix
AC3AC4_AUG_PROB = 0.5


def sampler_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step)."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence([seed, _STREAM, step]).generate_state(1)[0]))
    return gen


def _uniform(gen: torch.Generator, n: int = 1) -> list[float]:
    return torch.rand(n, generator=gen, dtype=torch.float64).tolist()


def _grayscale_from_uniform(uc, ub, ug):
    """(contrast 1 + 0.3 (u - 0.5), brightness 0.3 (u - 0.5), gamma
    2^(2u - 1)) from three uniforms in [0, 1): floats or tensors."""
    return 1.0 + (uc - 0.5) * 0.3, (ub - 0.5) * 0.3, 2.0 ** (ug * 2 - 1)


def _grayscale_params(gen: torch.Generator):
    """One grayscale jitter's (contrast, brightness, gamma), drawn on the
    host."""
    return _grayscale_from_uniform(*_uniform(gen, 3))


def _grayscale_single(img: torch.Tensor, c, b, g) -> torch.Tensor:
    """The grayscale jitter: clip(clip(img c + b) ^ g), to [0, 1]; c, b, g
    floats, or tensors that broadcast against img (one set per slice)."""
    out = torch.clamp(img * c + b, 0.0, 1.0)
    return torch.clamp(out ** g, 0.0, 1.0)



# ---------------------------------------------------------------- CVPPP


def pack_cvppp_arrays(pairs, padding: bool = True):
    """(image float32 (H, W, 3) RGB in [0, 1], label) pairs -> (images
    uint8 (N, Hp, Wp, 3), labels int32 (N, Hp, Wp)): round(image * 255),
    the image reflect- and the label zero-padded by (7, 7) rows and (22, 22)
    columns when ``padding`` (530x500 -> 544x544)."""
    imgs, labs = [], []
    for img, lab in pairs:
        img = np.round(np.asarray(img, np.float32) * 255.0).astype(np.uint8)
        lab = np.asarray(lab)
        if padding:
            img = np.pad(img, PAD + ((0, 0),), mode="reflect")
            lab = np.pad(lab, PAD, mode="constant")
        imgs.append(np.ascontiguousarray(img))
        labs.append(lab.astype(np.int32))
    return np.stack(imgs), np.stack(labs)


def load_cvppp_arrays(data_folder: str, valid_set: str = "local_20_1", padding: bool = True):
    """The training split read from disk (cv2) and packed."""
    d = os.path.join(data_folder, "train")
    return pack_cvppp_arrays(
        [(_read_rgb(os.path.join(d, n + "_rgb.png")),
          _read_gray(os.path.join(d, n + "_label.png")).astype(np.int32))
         for n in split_names(data_folder, valid_set)[0]], padding)


def _fallback_box(H: int, W: int, ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop's box when all 10 attempts fail: the centre crop
    with its aspect clamped to ``ratio``."""
    in_ratio = W / H
    if in_ratio < ratio[0]:
        cw = W
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = H
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = W, H
    return (H - ch) // 2, (W - cw) // 2, ch, cw


def rrc_box_at(H: int, W: int, scales, log_aspects, u_i: float, u_j: float,
               ratio=(3 / 4, 4 / 3)):
    """The box (i, j, ch, cw) from the attempts' area fractions ``scales``
    and log-aspects ``log_aspects`` and the corner's uniforms u_i, u_j: the
    first attempt that fits, its corner floor(u (n - side + 1)); else the
    fallback. float32 arithmetic, as the JAX function's."""
    ta = np.float32(H * W) * np.asarray(scales, np.float32)
    aspect = np.exp(np.asarray(log_aspects, np.float32))
    cw = np.round(np.sqrt(ta * aspect)).astype(np.int64)
    ch = np.round(np.sqrt(ta / aspect)).astype(np.int64)
    valid = (cw > 0) & (cw <= W) & (ch > 0) & (ch <= H)
    if not valid.any():
        return _fallback_box(H, W, ratio)
    k = int(np.argmax(valid))
    ch, cw = int(ch[k]), int(cw[k])
    i = int(np.floor(np.float32(u_i) * np.float32(H - ch + 1)))
    j = int(np.floor(np.float32(u_j) * np.float32(W - cw + 1)))
    return i, j, ch, cw


def rrc_box(gen: torch.Generator, H: int, W: int, scale=(0.7, 1.0), ratio=(3 / 4, 4 / 3)):
    """A RandomResizedCrop box: 10 (area, log-aspect) attempts drawn at
    once, the first that fits kept, as the host loop keeps it (the attempts
    are iid, and whether one fits depends on it alone)."""
    u = np.asarray(_uniform(gen, 22))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    return rrc_box_at(H, W, scale[0] + (scale[1] - scale[0]) * u[:10],
                      lo + (hi - lo) * u[10:20], u[20], u[21], ratio)


def _bilinear_coords(n: int, start: int, out: int, device):
    """cv2 INTER_LINEAR's source taps of ``out`` outputs over ``n`` inputs
    from ``start``: src = (dst + 0.5) n / out - 0.5, clamped; (lo, hi,
    weight of hi). The quotient is float32's correctly rounded one on every
    device: a CUDA tensor divided by a scalar is multiplied by its
    reciprocal, an ulp of src (6e-5 at 500) off, so it is divided in
    float64, whose rounding to float32 is exact here."""
    d = torch.arange(out, dtype=torch.float64, device=device)
    f = torch.clamp(((d + 0.5) * n / out).float() - 0.5, 0.0, n - 1.0)
    lo = torch.floor(f)
    hi = torch.clamp(lo + 1, max=n - 1)
    return start + lo.long(), start + hi.long(), f - lo


def _nearest_coords(n: int, start: int, out: int, device):
    """cv2 INTER_NEAREST's source index: floor(dst n / out), exact in
    integers."""
    d = torch.arange(out, dtype=torch.int64, device=device)
    return start + torch.clamp(torch.div(d * n, out, rounding_mode="floor"), max=n - 1)


def _resize_bilinear(img: torch.Tensor, rows, cols) -> torch.Tensor:
    """img (H, W, C) at the (lo, hi, weight) taps ``rows`` and ``cols``,
    rows first, in float32."""
    y0, y1, wy = rows
    x0, x1, wx = cols
    imf = img.float()
    imy = (imf.index_select(0, y0) * (1.0 - wy)[:, None, None]
           + imf.index_select(0, y1) * wy[:, None, None])
    return (imy.index_select(1, x0) * (1.0 - wx)[None, :, None]
            + imy.index_select(1, x1) * wx[None, :, None])


def crop_resize_bilinear(img: torch.Tensor, i: int, j: int, ch: int, cw: int,
                         out: int) -> torch.Tensor:
    """The box [i:i+ch, j:j+cw] of img (H, W, C) resized to (out, out, C)
    float32 with cv2's INTER_LINEAR conventions, the crop never
    materialised."""
    return _resize_bilinear(img, _bilinear_coords(ch, i, out, img.device),
                            _bilinear_coords(cw, j, out, img.device))


def crop_resize_nearest(lab: torch.Tensor, i: int, j: int, ch: int, cw: int,
                        out: int) -> torch.Tensor:
    """The label variant: cv2 INTER_NEAREST."""
    return (lab.index_select(0, _nearest_coords(ch, i, out, lab.device))
            .index_select(1, _nearest_coords(cw, j, out, lab.device)))


def _cvppp_params(gen: torch.Generator, n: int, H: int, W: int, scale=(0.7, 1.0),
                  ratio=(3 / 4, 4 / 3)) -> dict:
    """One CVPPP sample's draws: the image ``k``, the flips (each at 0.5)
    and the RandomResizedCrop ``box`` (i, j, ch, cw) at ``scale`` and
    ``ratio``."""
    k = int(torch.randint(0, n, (1,), generator=gen))
    u_hf, u_vf = _uniform(gen, 2)
    return {"k": k, "hflip": u_hf < 0.5, "vflip": u_vf < 0.5,
            "box": rrc_box(gen, H, W, scale, ratio)}


def _cvppp_sample(images: torch.Tensor, labels: torch.Tensor, p: dict, out: int,
                  normalize: bool = True) -> dict:
    """The sample at the draws ``p`` (:func:`_cvppp_params`): image k
    flipped, its box resized to (out, out) with the values on 0-255, /255,
    with ``normalize`` ImageNet-normalised."""
    _, H, W = labels.shape
    dev = images.device
    i, j, ch, cw = p["box"]
    rows, cols = _bilinear_coords(ch, i, out, dev), _bilinear_coords(cw, j, out, dev)
    rows_n, cols_n = _nearest_coords(ch, i, out, dev), _nearest_coords(cw, j, out, dev)
    # the box is cut from the flipped image: its indices, mirrored
    if p["hflip"]:
        cols = (W - 1 - cols[0], W - 1 - cols[1], cols[2])
        cols_n = W - 1 - cols_n
    if p["vflip"]:
        rows = (H - 1 - rows[0], H - 1 - rows[1], rows[2])
        rows_n = H - 1 - rows_n
    image = _resize_bilinear(images[p["k"]], rows, cols) / 255.0
    seg = labels[p["k"]].index_select(0, rows_n).index_select(1, cols_n)
    if not normalize:
        return {"image": image, "seg": seg}
    mean, std = imagenet_stats(dev)
    return {"image": (image - mean) / std, "seg": seg}


def sample_cvppp(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                 out: int = 544, scale=(0.7, 1.0), ratio=(3 / 4, 4 / 3),
                 normalize: bool = True) -> dict:
    """One training sample from the packed stacks (on any device): an
    image, a horizontal and a vertical flip at 0.5 each, a RandomResizedCrop
    box (area fraction in ``scale``, aspect in ``ratio``) resized to (out,
    out) with the values on 0-255, /255, with ``normalize`` the ImageNet
    normalisation. Returns {'image': (out, out, 3) float32, 'seg': (out,
    out) int32}."""
    n, H, W = labels.shape
    return _cvppp_sample(images, labels, _cvppp_params(gen, n, H, W, scale, ratio), out,
                         normalize)


def sample_cvppp_batch(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                       batch_size: int, out: int = 544, scale=(0.7, 1.0),
                       ratio=(3 / 4, 4 / 3), normalize: bool = True) -> dict:
    """``batch_size`` samples stacked: image (B, out, out, 3), seg (B, out,
    out)."""
    samples = [sample_cvppp(images, labels, gen, out, scale, ratio, normalize)
               for _ in range(batch_size)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


# ------------------------------------------------------------- BBBC039V1

def pad_bbbc_arrays(pairs, padding: int = 30):
    """(image, label) pairs -> (images float32 (N, H + 2p, W + 2p), labels
    int32), each padded with numpy's 'reflect'."""
    imgs = [np.pad(img, padding, mode="reflect") for img, _ in pairs]
    labs = [np.pad(lab, padding, mode="reflect") for _, lab in pairs]
    return np.stack(imgs).astype(np.float32), np.stack(labs).astype(np.int32)


def load_bbbc_arrays(data_folder: str, padding: int = 30):
    """The training split read from disk (cv2), normalised and padded."""
    return pad_bbbc_arrays(load_pairs(data_folder, "train"), padding)


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
                size: int = 256, padding: int = 30, aug_prob: float = AUG_PROB) -> dict:
    """One training sample from the padded stacks (on any device): an
    image, a random (size + 2 padding)^2 crop, the chain at p =
    ``aug_prob``, the centre size^2, the grayscale repeated to 3 channels.
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
    if u_aug < aug_prob:
        if p["elastic"] is not None:
            dev_gen = torch.Generator(device=images.device).manual_seed(p["elastic"])
            p["elastic"] = dw.elastic_field(dev_gen, crop, crop, device=images.device)
        img, lab = _bbbc_aug(img, lab, p)
    img = img[padding:padding + size, padding:padding + size]
    lab = lab[padding:padding + size, padding:padding + size]
    return {"image": img[..., None].expand(size, size, 3).contiguous(),
            "seg": lab.contiguous()}


def sample_bbbc_batch(images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                      batch_size: int, size: int = 256, padding: int = 30,
                      aug_prob: float = AUG_PROB) -> dict:
    """``batch_size`` samples stacked: image (B, size, size, 3), seg (B,
    size, size)."""
    samples = [sample_bbbc(images, labels, gen, size, padding, aug_prob)
               for _ in range(batch_size)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


# --------------------------------------------------------------- AC3/AC4

def load_ac3ac4_arrays(data_folder: str, dataset_name: str = "ac4", train_split: int = 80,
                       if_dilate: bool = True, crop_z: int = 18, arrays=None):
    """(raw uint8 (D, H, W), labels int32 (D, H, W)) of the training split:
    the HDF5 files' ``main`` (or ``arrays=(raw, label)`` in their place),
    the first ``train_split`` slices, with ``if_dilate`` the label borders
    widened by one pixel (:func:`..ops.affinity_np.seg_widen_border`), and
    both reflect-padded in z where the volume is thinner than ``crop_z``."""
    raw, label = read_volume(data_folder, dataset_name) if arrays is None else arrays
    raw = raw[:train_split]
    label = label[:train_split].astype(np.int64)
    if if_dilate:
        label = seg_widen_border(label, tsz_h=1)
    if raw.shape[0] < crop_z:
        pz = (crop_z - raw.shape[0]) // 2
        pad = ((pz, crop_z - raw.shape[0] - pz), (0, 0), (0, 0))
        raw = np.pad(raw, pad, mode="reflect")
        label = np.pad(label, pad, mode="reflect")
    return np.ascontiguousarray(raw, np.uint8), np.ascontiguousarray(label, np.int32)


def _rot90_xy(vol: torch.Tensor, k: int) -> torch.Tensor:
    """rot90 by k quarter turns in the (y, x) plane of a (D, H, W) volume."""
    return torch.rot90(vol, k, dims=(1, 2)) if k % 4 else vol


def _flip_rule4(vol: torch.Tensor, rule) -> torch.Tensor:
    """The 4-bit rule on a (D, H, W) volume, in its order: z-flip, x-flip,
    y-flip, xy-transpose (H == W)."""
    if rule[0]:
        vol = vol.flip(0)
    if rule[1]:
        vol = vol.flip(2)
    if rule[2]:
        vol = vol.flip(1)
    if rule[3]:
        vol = vol.transpose(1, 2)
    return vol


# the AC3/AC4 intensity jitter at its parameters: the grayscale jitter with
# one (contrast, brightness, gamma) for the volume (floats), or one per slice
# ((D, 1, 1) tensors)
_intensity_3d_single = _grayscale_single


def _missing_section_single(vol: torch.Tensor, sections) -> torch.Tensor:
    """Missing sections: each (z, fill) of ``sections`` replaces slice z by
    zeros (fill None) or by ``fill``, an (H, W) map."""
    out = vol.clone()
    for z, fill in sections:
        out[z] = 0.0 if fill is None else fill
    return out


def _misalign_single(vol: torch.Tensor, lab: torch.Tensor, z0: int, dy: int, dx: int):
    """Misalignment: the slices z >= z0 of the image and the label shifted
    rigidly by (dy, dx), 0 where the shift uncovers."""
    def shift(a):
        h, w = a.shape[1:]
        out = a.clone()
        out[z0:] = 0
        out[z0:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
            a[z0:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
        return out

    return shift(vol), shift(lab)


def _elastic_xy_single(vol: torch.Tensor, lab: torch.Tensor, dx: torch.Tensor,
                       dy: torch.Tensor):
    """One elastic field (dx, dy) (H, W) for every slice, 0 outside: the
    image bilinear, the label nearest."""
    mx, my = dw.elastic_coords(dx, dy)
    return dw.remap_bilinear(vol, mx, my, "constant"), dw.remap_nearest(lab, mx, my, "constant")


def _augs_mix_params(gen: torch.Generator, d: int) -> dict:
    """One sample's host draws of _augs_mix for a crop of ``d`` slices: each
    link's gate and parameters, and ``seed`` for its draws on the device.
    ``gray``: None (off), "slices" (one jitter per slice, drawn on the
    device) or the whole volume's (c, b, g); ``em``: None, ("missing", [(z,
    noise-filled), ...]) or ("misalign", (z0, dy, dx))."""
    g_flip, g_rot, g_el, g_gs, u_mode, g_em, g_miss, u_n1, u_n2 = _uniform(gen, 9)
    whole = _grayscale_params(gen)
    rule = [int(b) for b in torch.randint(0, 2, (4,), generator=gen)]
    k, n, z1, z2, z0, dy, dx = (int(torch.randint(lo, hi, (1,), generator=gen)) for lo, hi in
                                ((0, 4), (1, 3), (0, d), (0, d - 1), (1, d), (-10, 11),
                                 (-10, 11)))
    z2 += z2 >= z1  # distinct from z1
    em = None
    if g_em < 0.2:
        em = (("missing", [(z1, u_n1 < 0.5), (z2, u_n2 < 0.5)][:n]) if g_miss < 0.5
              else ("misalign", (z0, dy, dx)))
    return {"flip": rule if g_flip > 0.5 else None, "rot": k if g_rot > 0.5 else 0,
            "elastic": g_el < 0.5,
            "gray": None if g_gs >= 0.5 else "slices" if u_mode < 0.5 else whole,
            "em": em, "seed": int(torch.randint(0, 2 ** 62, (1,), generator=gen))}


def _augs_mix_draw(p: dict, shape, device) -> dict:
    """``p`` with its device draws made: the elastic field (dx, dy), the
    per-slice jitters and the noise fills, from a generator on ``device``
    seeded by ``p['seed']`` (made only when a link needs it)."""
    d, h, w = shape
    gen = None

    def dev_gen():
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(p["seed"])
        return gen

    p = dict(p)
    p["elastic"] = dw.elastic_field(dev_gen(), h, w, device=device) if p["elastic"] else None
    if p["gray"] == "slices":
        p["gray"] = _grayscale_from_uniform(*torch.rand((3, d, 1, 1), generator=dev_gen(),
                                                        device=device))
    if p["em"] is not None and p["em"][0] == "missing":
        p["em"] = ("missing", [
            (z, torch.rand((h, w), generator=dev_gen(), device=device) if noise else None)
            for z, noise in p["em"][1]])
    return p


def _augs_mix(img: torch.Tensor, lab: torch.Tensor, p: dict):
    """The reference's _augs_mix on one (D, H, W) image in [0, 1] and its
    label at the parameters ``p`` (:func:`_augs_mix_draw`): the 4-bit flip,
    rot90, the elastic field, the intensity jitter (c, b, g), the missing
    sections or the misalignment, each where drawn."""
    if p["flip"] is not None:
        img, lab = _flip_rule4(img, p["flip"]), _flip_rule4(lab, p["flip"])
    img, lab = _rot90_xy(img, p["rot"]), _rot90_xy(lab, p["rot"])
    if p["elastic"] is not None:
        img, lab = _elastic_xy_single(img, lab, *p["elastic"])
    if p["gray"] is not None:
        img = _intensity_3d_single(img, *p["gray"])
    if p["em"] is not None:
        kind, arg = p["em"]
        if kind == "missing":
            img = _missing_section_single(img, arg)
        else:
            img, lab = _misalign_single(img, lab, *arg)
    return img, lab


def _ac3ac4_params(gen: torch.Generator, shape, crop_from: tuple,
                   aug_prob: float = AC3AC4_AUG_PROB) -> dict:
    """One AC3/AC4 sample's host draws: the crop's corner in a volume of
    ``shape``, whether it is augmented (at ``aug_prob``) and _augs_mix's
    draws (:func:`_augs_mix_params`)."""
    corner = tuple(int(torch.randint(0, n - c + 1, (1,), generator=gen))
                   for n, c in zip(shape, crop_from))
    (u_aug,) = _uniform(gen)
    return {"corner": corner, "aug": u_aug < aug_prob,
            "mix": _augs_mix_params(gen, crop_from[0])}


def _ac3ac4_sample(raw: torch.Tensor, label: torch.Tensor, p: dict, crop_size,
                   padding: int) -> dict:
    """The sample at the draws ``p`` (:func:`_ac3ac4_params`): the (cz, cy
    + 2 padding, cx + 2 padding) crop at p's corner, /255, _augs_mix where
    p's gate says so, the centre crop_size."""
    cz, cy, cx = crop_size
    cfo = (cz, cy + 2 * padding, cx + 2 * padding)
    (rz, ry, rx), (oz, oy, ox) = p["corner"], (0, padding, padding)
    if p["aug"]:
        img = raw[rz:rz + cz, ry:ry + cfo[1], rx:rx + cfo[2]].float() / 255.0
        lab = label[rz:rz + cz, ry:ry + cfo[1], rx:rx + cfo[2]]
        img, lab = _augs_mix(img, lab, _augs_mix_draw(p["mix"], cfo, raw.device))
        img = img[:, oy:oy + cy, ox:ox + cx]
        lab = lab[:, oy:oy + cy, ox:ox + cx]
    else:  # the centre of the crop, cut at once
        ry, rx = ry + oy, rx + ox
        img = raw[rz:rz + cz, ry:ry + cy, rx:rx + cx].float() / 255.0
        lab = label[rz:rz + cz, ry:ry + cy, rx:rx + cx]
    return {"image": img[..., None].contiguous(), "seg": lab.contiguous()}


def sample_ac3ac4(raw: torch.Tensor, label: torch.Tensor, gen: torch.Generator,
                  crop_size=(18, 160, 160), padding: int = 50,
                  aug_prob: float = AC3AC4_AUG_PROB) -> dict:
    """One training sample from the volume (on any device): a random (cz,
    cy + 2 padding, cx + 2 padding) crop, /255, _augs_mix at p =
    ``aug_prob``, the centre crop_size. Returns {'image': (cz, cy, cx, 1)
    float32 in [0, 1], 'seg': (cz, cy, cx) int32}."""
    cz, cy, cx = crop_size
    p = _ac3ac4_params(gen, label.shape, (cz, cy + 2 * padding, cx + 2 * padding), aug_prob)
    return _ac3ac4_sample(raw, label, p, crop_size, padding)


def sample_ac3ac4_batch(raw: torch.Tensor, label: torch.Tensor, gen: torch.Generator,
                        batch_size: int, crop_size=(18, 160, 160), padding: int = 50,
                        aug_prob: float = AC3AC4_AUG_PROB) -> dict:
    """``batch_size`` samples stacked: image (B, cz, cy, cx, 1), seg (B, cz,
    cy, cx)."""
    samples = [sample_ac3ac4(raw, label, gen, crop_size, padding, aug_prob)
               for _ in range(batch_size)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
