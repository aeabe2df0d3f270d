"""Synthetic data made on the card from the seed, frozen in the benchmark.

Device forms of the program's synthesizers (``chip_smoke.leaf_pairs`` for
CVPPP-like plants, ``data.ac3ac4.synthesize_volume`` for an EM-like volume),
kept here so that a change to the program cannot change the yardstick, and
written for the card so that a run's set-up makes its data in a few large
calls. The same seed gives the same data on the same card.

Leaves: 6-13 elliptic leaves around the image centre, drawn in order (a later
leaf covers an earlier one); a dark noisy background, the leaves one green
a plant; values rounded to uint8 and reflect-padded as the CVPPP loader pads
530x500 images to 544x544, the labels zero-padded.

EM volume: the Voronoi cells of one jittered seed point a grid cell, with z
distances scaled by 4 (anisotropic sections); 180 inside a cell, 60 on the
voxels whose label differs from the previous voxel along an axis, Gaussian
noise of sigma 15, uint8. The labels get Kisuk Lee's border widening per
section (a voxel becomes 0 where its 3x3 window, mirrored at the edge, holds
more than one id), as the AC3/AC4 loader widens them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# EM sections are anisotropic: z distances count 4x in the Voronoi cells
Z_SCALE = 4.0
# ImageNet's per-channel mean and std, which the CVPPP pipeline normalises by
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# a leaf's green channel is 0.4-0.8 and the background's ~0.1
LEAF_GREEN = 0.25
# a cell's interior is 180/255 and its membrane 60/255, before any jitter
MEMBRANE_CONTRAST = 0.1


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, tag)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(tag)]).generate_state(1)[0]))
    return gen


def _u(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def leaf_stack(n: int, h: int, w: int, pad_hw, seed: int, device, chunk: int = 12):
    """(images uint8 (n, H, W, 3), labels int32 (n, H, W)) on ``device``:
    ``n`` plants of h x w padded by ``pad_hw`` = ((top, bottom), (left,
    right))."""
    gen = generator(seed, 1, device)
    max_leaves = 13
    m = min(h, w)
    n_leaves = torch.randint(6, 14, (n, 1), generator=gen, device=device)
    ang = _u(gen, (n, max_leaves), 0, 2 * math.pi)
    dist = _u(gen, (n, max_leaves), m / 12, m / 2.6)
    ay = _u(gen, (n, max_leaves), m / 20, m / 7)
    ax = _u(gen, (n, max_leaves), m / 40, m / 12)
    rot = _u(gen, (n, max_leaves), 0, math.pi)
    green = _u(gen, (n,), 0.4, 0.8)
    cy, cx = h / 2 + dist * torch.sin(ang), w / 2 + dist * torch.cos(ang)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    (pt, pb), (pl, pr) = pad_hw
    images = torch.empty((n, h + pt + pb, w + pl + pr, 3), dtype=torch.uint8, device=device)
    labels = torch.empty((n, h + pt + pb, w + pl + pr), dtype=torch.int32, device=device)
    ids = torch.arange(1, max_leaves + 1, device=device)
    for i0 in range(0, n, chunk):
        s = slice(i0, min(n, i0 + chunk))
        dy = yy[None, None] - cy[s, :, None, None]
        dx = xx[None, None] - cx[s, :, None, None]
        c, si = torch.cos(rot[s])[..., None, None], torch.sin(rot[s])[..., None, None]
        u, v = dy * c + dx * si, -dy * si + dx * c
        inside = (u / ay[s, :, None, None]) ** 2 + (v / ax[s, :, None, None]) ** 2 <= 1
        inside &= (ids[None] <= n_leaves[s])[..., None, None]
        label = (inside * ids[None, :, None, None]).amax(dim=1)
        k = label.shape[0]
        img = 0.1 + 0.03 * torch.randn((k, h, w, 3), generator=gen, device=device)
        leaf = torch.stack([torch.full_like(green[s], 0.15), green[s],
                            torch.full_like(green[s], 0.1)], -1)[:, None, None, :]
        img = torch.where((label > 0)[..., None], leaf, img)
        img = torch.clamp(img + 0.02 * torch.randn(img.shape, generator=gen, device=device), 0, 1)
        img = torch.round(img * 255.0)
        img = F.pad(img.permute(0, 3, 1, 2), (pl, pr, pt, pb), mode="reflect").permute(0, 2, 3, 1)
        images[s] = img.to(torch.uint8)
        labels[s] = F.pad(label.to(torch.int32), (pl, pr, pt, pb))
    return images, labels


def widen_border(label: torch.Tensor) -> torch.Tensor:
    """Per section of (D, H, W) ids: 0 where the 3x3 window (mirrored at the
    edge, the edge not repeated) holds more than one positive id."""
    x = label.to(torch.float32)[:, None]
    big = x.max() + 1
    hi = F.max_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, stride=1)
    lo = -F.max_pool2d(-F.pad(torch.where(x == 0, big, x), (1, 1, 1, 1), mode="reflect"),
                       3, stride=1)
    return (label * (hi == lo)[:, 0]).to(label.dtype)


def em_volume(shape, cell, seed: int, tag: int, device):
    """(raw uint8 (D, H, W), labels int32 (D, H, W), widened) on ``device``:
    Voronoi cells of one jittered seed a ``cell``-sized grid cell."""
    gen = generator(seed, tag, device)
    d, h, w = shape
    g = [int(math.ceil(n / c)) + 2 for n, c in zip(shape, cell)]  # one cell of margin a side
    jitter = torch.rand(g + [3], generator=gen, device=device, dtype=torch.float64)
    idx = torch.stack(torch.meshgrid(*[torch.arange(n, device=device, dtype=torch.float64)
                                       for n in g], indexing="ij"), -1)
    size = torch.tensor(cell, device=device, dtype=torch.float64)
    points = (idx - 1 + jitter) * size  # (gz, gy, gx, 3) voxel coordinates
    scale = torch.tensor([Z_SCALE, 1.0, 1.0], device=device, dtype=torch.float64)
    label = torch.empty(shape, dtype=torch.int32, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float64)
    xs = torch.arange(w, device=device, dtype=torch.float64)
    gy, gx = (ys / cell[1]).long() + 1, (xs / cell[2]).long() + 1
    for z in range(d):
        gz = z // cell[0] + 1
        best = torch.full((h, w), float("inf"), device=device, dtype=torch.float64)
        arg = torch.zeros((h, w), dtype=torch.long, device=device)
        for oz in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for ox in (-1, 0, 1):
                    cz, cy, cx = gz + oz, (gy + oy)[:, None], (gx + ox)[None, :]
                    p = points[cz, cy, cx]  # (h, w, 3)
                    dist = (((p[..., 0] - z) * scale[0]) ** 2 + (p[..., 1] - ys[:, None]) ** 2
                            + (p[..., 2] - xs[None, :]) ** 2)
                    better = dist < best
                    best = torch.where(better, dist, best)
                    arg = torch.where(better, (cz * g[1] + cy) * g[2] + cx, arg)
        label[z] = (arg + 1).to(torch.int32)
    edge = torch.zeros(shape, dtype=torch.bool, device=device)
    edge[1:] |= label[1:] != label[:-1]
    edge[:, 1:] |= label[:, 1:] != label[:, :-1]
    edge[:, :, 1:] |= label[:, :, 1:] != label[:, :, :-1]
    raw = torch.where(edge, 60.0, 180.0) + 15.0 * torch.randn(shape, generator=gen, device=device)
    raw = torch.clamp(raw, 0, 255).to(torch.uint8)
    return raw, widen_border(label)


def alignment_gap(kind: str, image: torch.Tensor, seg: torch.Tensor) -> float:
    """How far a sampled batch's labels are from its image, by what this
    module's data looks like. Leaves (image (B, H, W, 3) ImageNet-normalised,
    seg (B, H, W)): the largest share, per sample, of pixels inside a label
    (their four neighbours carry the same one, so a resize's blend at the
    edges does not count) where "green above ``LEAF_GREEN``" and "labelled"
    disagree. EM volume (image (B, D, H,
    W, 1) in [0, 1], seg (B, D, H, W)): the share of sections in which the
    labelled voxels are brighter than the border voxels (label 0) by less
    than ``MEMBRANE_CONTRAST`` (a missing section, which the sampler's
    augmentation draws now and then, is one such)."""
    if kind == "leaves":
        mean = torch.tensor(IMAGENET_MEAN, device=image.device)
        std = torch.tensor(IMAGENET_STD, device=image.device)
        green = ((image * std + mean)[..., 1] > LEAF_GREEN)[:, 1:-1, 1:-1]
        c = seg[:, 1:-1, 1:-1]
        inner = ((c == seg[:, :-2, 1:-1]) & (c == seg[:, 2:, 1:-1])
                 & (c == seg[:, 1:-1, :-2]) & (c == seg[:, 1:-1, 2:]))
        off = ((green != (c > 0)) & inner).flatten(1).sum(1)
        return float((off / inner.flatten(1).sum(1).clamp(min=1)).max())
    img, fg = image[..., 0].double().flatten(2), (seg > 0).flatten(2)  # (B, D, HW)
    n_fg, n_bg = fg.sum(-1), (~fg).sum(-1)
    inside = (img * fg).sum(-1) / n_fg.clamp(min=1)
    border = (img * ~fg).sum(-1) / n_bg.clamp(min=1)
    dim = (inside - border < MEMBRANE_CONTRAST) | (n_fg == 0) | (n_bg == 0)
    return float(dim.double().mean())
