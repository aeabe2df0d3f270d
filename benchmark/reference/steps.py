"""The training steps' losses, plain: CVPPP (2D) and AC3/AC4 (3D).

One step: targets from the labels; the student's forward; the teacher's
forward of the EMA view under no_grad, in train mode as the student's (the
step stop-gradients the teacher); the teacher's embedding un-flipped by its
rule; the full-scale self loss, the cross-view loss (the student against the
shifted teacher) and deep supervision of the four coarser heads; then the
backward and AMSGrad.
"""

from __future__ import annotations

import torch

from . import ops


def loss_2d(model, batch: dict, shifts, neighbor: int = 4, affs0_weight: float = 1.0):
    """``batch``: image and ema_image (B, H, W, 3), seg (B, H, W), rules (B, 3).
    Deep supervision: head e_k (1/2 .. 1/16) against pyramid level k with the
    first neighbor / 2 * (4 - k) offsets."""
    offsets = ops.offsets_2d(shifts, neighbor)
    seg = batch["seg"]
    affs, mask = ops.targets_2d(seg, offsets)
    wmap = ops.binary_ratio_weights(affs, (-2, -1))
    outs = model(batch["image"].permute(0, 3, 1, 2))
    with torch.no_grad():
        teacher = model(batch["ema_image"].permute(0, 3, 1, 2))[4]
    teacher = ops.unflip_2d(teacher.permute(0, 2, 3, 1), batch["rules"])
    heads = [o.permute(0, 2, 3, 1) for o in outs[:5]]
    emb = heads[4]
    loss = ops.self_loss_2d(emb, affs, wmap, mask, offsets)
    for k, (head, lab) in enumerate(zip(heads[3::-1], ops.pyramid_2d(seg))):
        n = neighbor // 2 * (4 - k)
        a, m = ops.targets_2d(lab, offsets[:n])
        loss = loss + ops.self_loss_2d(head, a, ops.binary_ratio_weights(a, (-2, -1)), m,
                                       offsets[:n])
    return loss + ops.cross_loss_2d(emb, teacher, affs, wmap, mask, offsets, affs0_weight)


def loss_3d(model, batch: dict, affs0_weight: float = 1.0):
    """``batch``: image and ema_image (B, D, H, W, 1), seg (B, D, H, W),
    rules (B, 4). The norm5 self and cross losses over the 12-shift table;
    norm1 deep supervision of e1 (1/16) .. e4 (1/2) against levels 4 .. 1."""
    seg = batch["seg"]
    dims = (-3, -2, -1)
    table = ops.offsets_3d()
    affs = ops.targets_3d(seg, table)
    wmap = ops.binary_ratio_weights(affs, dims)
    outs = model(batch["image"].permute(0, 4, 1, 2, 3))
    with torch.no_grad():
        teacher = model(batch["ema_image"].permute(0, 4, 1, 2, 3))[4]
    teacher = ops.unflip_3d(teacher.permute(0, 2, 3, 4, 1), batch["rules"])
    heads = [o.permute(0, 2, 3, 4, 1) for o in outs]
    emb = heads[4]
    kw = dict(affs0_weight=affs0_weight)
    loss = ops.slab_loss_3d(ops.affinities(emb, emb, table), affs, wmap, ops.SHIFTS_3D, **kw)
    loss = loss + ops.slab_loss_3d(ops.affinities(emb, teacher, table), affs, wmap,
                                   ops.SHIFTS_3D, **kw)
    unit = ops.offsets_3d((1, 1, 1))
    for head, lab in zip(heads[:4], ops.pyramid_xy(seg)[::-1]):
        t = ops.unit_targets_3d(lab)
        loss = loss + ops.slab_loss_3d(ops.affinities(head, head, unit), t,
                                       ops.binary_ratio_weights(t, dims), (1, 1, 1),
                                       scaled=1, **kw)
    return loss
