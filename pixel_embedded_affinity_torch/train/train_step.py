"""The train steps, 2D (CVPPP, BBBC039) and 3D (AC3/AC4), and the 2D eval step.

One train step, as the JAX package's ``make_train_step_2d``:
targets built on the device from the labels (``device_gt``), or taken
from the batch that a host sampler built them into; the EMA view drawn on
the device for this step (``device_ema``), or taken from the batch; the student forward, then
the EMA view's forward under ``no_grad`` (the JAX step stop-gradients the
teacher), so the BatchNorm running statistics update twice, in that order,
as the JAX step chains them; the teacher's embedding un-flipped; deep
supervision of e4, e3, e2, e1 (1/2 .. 1/16 scale) against the pyramid
levels 1..4 with ``neighbor // 2 * (4 - k)`` offsets; the full-scale self
loss and the cross-view loss; with ``loss_mode="discriminative"`` (the
ResNet presets) ``disc_weight`` times the discriminative loss of the
full-scale embedding against the labels; with ``mask_weight`` (BBBC) the
mask head's loss against the foreground; backward; AMSGrad. The model
computes in its dtype (``model.dtype``): in float32 every convolution, the
backward ones too, runs with TF32 off; in bfloat16 the model casts the
image at its first convolutions, student and teacher compute in bfloat16 as Flax's
dtype rule has it (:func:`..models.common.set_compute_dtype`), the
un-flip keeps the teacher's dtype, the losses hand the bfloat16
embeddings to the kernels and come out float32, and the parameters, their
gradients and AMSGrad's state stay float32. The model is NCHW; the
losses take its outputs as ``permute(0, 2, 3, 1)`` views with no copy.

The JAX default trains an exact twin of the model in a TPU layout
(``models/resunet2d_s2d.py``); the port has the one model.

The 3D step, as ``make_train_step_3d``: the 12-channel targets and their
pyramid built on the device (or taken from the batch); the EMA view
(intensity, cutout, 4-bit flip) drawn on the device (or taken from the
batch); the student forward, then the teacher's under
``no_grad``; the teacher un-flipped by its rule; the norm5 self and cross
losses through the 3D kernels (with another ``embedding_mode`` than 5,
norm1 at full scale, as the JAX step chooses); norm1 deep supervision of e1..e4 (1/16 .. 1/2 in y,
x) against the pyramid levels 4..1; backward; AMSGrad. The JAX model
rematerialises its blocks to fit a TPU's memory; with the teacher under
``no_grad`` only the student's activations are held, and the port keeps
them.

Data parallelism (``mesh``, :mod:`..parallel.mesh`, world size N > 1): every
rank calls the step with the same global batch; the step draws the EMA view
of the whole batch from (seed, step), so the views are the one-process
step's, and trains on its rank's contiguous shard. The model's BatchNorms
take the global batch's statistics (:func:`..models.common.bind_mesh`), the
mask head's loss its global counts, and after the backward one all-reduce
of one flat buffer takes the mean over the ranks of the gradients and the
metrics; every other loss term is normalised by its batch size times a
shape, so the mean of the shards' terms is the global batch's. Each rank's
optimizer then takes the same step, and the parameters stay equal across
the ranks. At world size 1 nothing of this runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..data.ac3ac4 import convert_consistency_flip_3d_rule4
from ..data.consistency import convert_consistency_flip, imagenet_stats
from ..data.device_aug import ema_generator, ema_view_2d, ema_view_3d
from ..device import deterministic_convs, float32_convs
from ..models.common import bind_mesh
from ..ops.losses import (ema_embedding_loss_2d, embedding_loss_2d, embedding_loss_norm1,
                          embedding_loss_norm5, mask_head_loss, weighted_mse)
from ..ops.losses_extra import discriminative_loss
from ..ops.offsets import SHIFTS_3D
from ..ops.targets import build_targets_2d, build_targets_3d
from ..parallel.mesh import all_reduce_mean_, shard_batch
from ..utils.profiling import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def deep_weight_factors(deep_weight) -> list[float]:
    if deep_weight == 1:
        return [1.0, 1.0, 1.0, 1.0, 1.0]
    if deep_weight == 2:
        return [0.01, 0.03, 0.1, 0.3, 1.0]
    return [float(deep_weight), 1.0, 1.0, 1.0, 1.0]


def batch_targets_2d(batch: dict, nb_half: int):
    """(affs, wmap, mask, downs) from a batch a host sampler built: the
    JAX layout's ``down1..4`` (B, 3 n, h, w), the level's targets, weights
    and masks along channels, split into contiguous (t, w, m), and the
    uint8 masks as float32, the forms :func:`build_targets_2d` gives."""
    downs = []
    for lvl in range(4):
        n = nb_half * (4 - lvl)
        d = batch[f"down{lvl + 1}"].float()
        downs.append(tuple(d[:, i * n:(i + 1) * n].contiguous() for i in range(3)))
    return (batch["affs"].float(), batch["wmap"].float(), batch["mask"].float(), downs)


def batch_targets_3d(batch: dict):
    """(affs, wmap, downs) from a batch a host sampler built: ``down1..4``
    (B, 6, D, h, w) split into contiguous (targets, weights), the forms
    :func:`build_targets_3d` gives."""
    downs = [tuple(batch[f"down{k}"][:, i * 3:(i + 1) * 3].float().contiguous()
                   for i in range(2)) for k in range(1, 5)]
    return batch["affs"].float(), batch["wmap"].float(), downs


class _DataParallel:
    """What the 2D and 3D steps share on a data-parallel ``mesh``."""

    mesh = None

    def _backward(self, model, loss, metrics):
        """``loss.backward()``, then on a mesh the mean over the ranks of the
        gradients (parameters without one stay skipped) and of the metrics,
        in one all-reduce."""
        loss.backward()
        if self.mesh is not None:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            all_reduce_mean_(self.mesh, grads + list(metrics.values()))

    def __call__(self, state: TrainState, batch: dict):
        with span("pea.step"):
            if self.device_ema:
                with span("pea.ema_view"):
                    batch = self.ema_batch(batch, state.step)
            pred, metrics = self.grads(state.model, shard_batch(batch, self.mesh))
            state.optimizer.step()
            state.step += 1
            return pred, metrics

    def _train_mode(self, model):
        if self.mesh is not None:
            bind_mesh(model, self.mesh)
        model.train()
        model.zero_grad(set_to_none=True)


def _nchw(image_bhwc: torch.Tensor) -> torch.Tensor:
    return image_bhwc.permute(0, 3, 1, 2).contiguous()


def _bhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    return x_nchw.permute(0, 2, 3, 1)


class TrainStep2D(_DataParallel):
    """``step(state, batch) -> (pred, metrics)`` updates ``state`` in place.

    ``batch``: tensors on one device, ``image`` (B, H, W, 3), ImageNet-
    normalised with ``imagenet_norm`` (the cvppp pipeline's) or in [0, 1]
    without (BBBC's), ``seg`` (B, H, W) integer labels, when ``device_ema``
    is False ``ema_image`` and ``rules`` (B, 3), and when ``device_gt`` is
    False the host-built ``affs``, ``wmap``, ``mask`` and ``down1..4``
    (:func:`batch_targets_2d`). ``pred`` is relu of the full-scale
    affinities (monitoring); ``metrics`` holds 0-d tensors (loss,
    loss_embedding, loss_cross[, loss_disc][, loss_mask][, loss_ct]).

    ``use_pallas=False`` is the plain path. With ``use_pallas`` the
    WeightedMSE loss goes through the loss-fused kernels K2/K3
    (``fuse_loss=True``); unfused (``fuse_loss=False``, or another
    criterion) the affinities come from K1 and K4, forward and backward,
    and the criterion is applied to them. ``mask_weight`` adds
    ``mask_weight * mask_head_loss`` of the mask head against ``seg > 0``,
    and ``loss_mode="discriminative"`` adds ``disc_weight *
    discriminative_loss`` of the full-scale embedding against ``seg``.
    ``mesh``: train data-parallel on it (the module's docstring).
    """

    def __init__(self, offsets, *, neighbor: int = 4, criterion=weighted_mse,
                 affs0_weight: float = 1.0, deep_weight=1, self_emb: float = 1.0,
                 cross_emb: float = 1.0, mask_weight: float = 0.0, ct_weight: float = 0.0,
                 loss_mode: str = "affinity", disc_weight: float = 1.0,
                 use_pallas: bool = True, fuse_loss: bool = True, imagenet_norm: bool = True,
                 device_gt: bool = True, device_ema: bool = True, ema_seed: int = 0,
                 ema_noise: bool = False, ema_blur: bool = False,
                 ema_intensity: bool = True, ema_mask: bool = True,
                 ema_flip: bool = True, mesh=None):
        self.mesh = mesh
        self.offsets = [tuple(map(int, o)) for o in offsets]
        self.neighbor = neighbor
        self.criterion = criterion
        self.affs0_weight = affs0_weight
        self.dwf = deep_weight_factors(deep_weight)
        self.self_emb, self.cross_emb = self_emb, cross_emb
        self.mask_weight, self.ct_weight = mask_weight, ct_weight
        self.loss_mode, self.disc_weight = loss_mode, disc_weight
        self.use_pallas, self.fuse_loss = use_pallas, fuse_loss
        self.imagenet_norm = imagenet_norm
        self.device_gt = device_gt
        self.device_ema, self.ema_seed = device_ema, ema_seed
        self.ema_flags = dict(noise=ema_noise, blur=ema_blur, intensity=ema_intensity,
                              mask=ema_mask, flip=ema_flip)

    def ema_batch(self, batch: dict, step: int) -> dict:
        """``batch`` with the EMA view and its rules drawn for ``step``: the
        view is drawn from the [0, 1] image, so with ``imagenet_norm`` from
        the de-normalised one, normalised again after."""
        img = batch["image"]
        gen = ema_generator(self.ema_seed, step, img.device)
        if not self.imagenet_norm:
            ema, rules = ema_view_2d(img, batch["seg"] > 0, gen, **self.ema_flags)
            return dict(batch, ema_image=ema, rules=rules)
        mean, std = imagenet_stats(img.device, img.dtype)
        ema, rules = ema_view_2d(img * std + mean, batch["seg"] > 0, gen, **self.ema_flags)
        return dict(batch, ema_image=(ema - mean) / std, rules=rules)

    def loss(self, model, batch: dict):
        """(loss, pred, metrics) of a batch that carries ``ema_image`` and
        ``rules``, with the autograd graph; run it under float32_convs."""
        offsets, nb_half = self.offsets, self.neighbor // 2
        kw = dict(criterion=self.criterion, use_pallas=self.use_pallas,
                  fuse_loss=self.fuse_loss)
        if self.device_gt:
            affs_t, wmap_t, mask_t, downs = build_targets_2d(batch["seg"], offsets,
                                                             neighbor=self.neighbor)
        else:
            affs_t, wmap_t, mask_t, downs = batch_targets_2d(batch, nb_half)
        outs = model(_nchw(batch["image"]))
        with torch.no_grad():
            ema = model(_nchw(batch["ema_image"]))[4]
        ema = convert_consistency_flip(_bhwc(ema), batch["rules"])
        e1, e2, e3, e4, embedding = (_bhwc(o) for o in outs[:5])

        deep = []
        for k, (emb, (t, w, m)) in enumerate(zip([e4, e3, e2, e1], downs)):
            n = nb_half * (4 - k)
            lk, _ = embedding_loss_2d(emb, t, w, m, offsets[:n], **kw)
            deep.append(lk)
        loss_embedding, pred = embedding_loss_2d(embedding, affs_t, wmap_t, mask_t,
                                                 offsets, **kw)
        loss_cross, _ = ema_embedding_loss_2d(embedding, ema, affs_t, wmap_t, mask_t,
                                              offsets, affs0_weight=self.affs0_weight,
                                              **kw)
        dwf = self.dwf
        loss_self = (loss_embedding * dwf[0] + deep[0] * dwf[1] + deep[1] * dwf[2]
                     + deep[2] * dwf[3] + deep[3] * dwf[4])
        loss_cross_total = loss_cross * dwf[0] * self.cross_emb
        loss = loss_self * self.self_emb + loss_cross_total
        metrics = {"loss_embedding": (loss_self * self.self_emb).detach(),
                   "loss_cross": loss_cross_total.detach()}
        if self.loss_mode == "discriminative":
            ld = discriminative_loss(embedding, batch["seg"])
            loss = loss + self.disc_weight * ld
            metrics["loss_disc"] = ld.detach()
        if self.mask_weight:
            lm = mask_head_loss(_bhwc(outs[5]), batch["seg"] > 0, mesh=self.mesh)
            loss = loss + self.mask_weight * lm
            metrics["loss_mask"] = lm.detach()
        if self.ct_weight:
            lc = torch.mean((embedding - ema) ** 2)
            loss = loss + self.ct_weight * lc
            metrics["loss_ct"] = lc.detach()
        metrics["loss"] = loss.detach()
        return loss, torch.relu(pred.detach()), metrics

    def grads(self, model, batch: dict):
        """Forward and backward in train mode; the gradients land in
        ``.grad``, on a mesh their mean over the ranks. Returns (pred,
        metrics)."""
        self._train_mode(model)
        with float32_convs():
            loss, pred, metrics = self.loss(model, batch)
            self._backward(model, loss, metrics)
        return pred, metrics


def _ncdhw(image_bdhwc: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, C, D, H, W) with standard NCDHW strides. At
    C = 1 the permuted view is contiguous already, and its channel stride of
    1 would read as channels-last to cuDNN, which converts such tensors
    around its NCDHW float32 3D kernels; whether the view had been copied
    would then set the embedding's layout. Standard strides keep the
    student's and the teacher's embeddings, the affinity kernels' inputs,
    in one layout."""
    x = image_bdhwc.permute(0, 4, 1, 2, 3).contiguous()
    return x.view(x.shape)


def _bdhwc(x_ncdhw: torch.Tensor) -> torch.Tensor:
    return x_ncdhw.permute(0, 2, 3, 4, 1)


class TrainStep3D(_DataParallel):
    """``step(state, batch) -> (pred, metrics)`` updates ``state`` in place.

    ``batch``: tensors on one device, ``image`` (B, D, H, W, 1) in [0, 1],
    ``seg`` (B, D, H, W) integer labels, when ``device_ema`` is False
    ``ema_image`` and ``rules`` (B, 4), and when ``device_gt`` is False the
    host-built ``affs``, ``wmap`` and ``down1..4`` (:func:`batch_targets_3d`).
    ``pred`` is relu of the full-scale self affinities (B, K, D, H, W) after
    the boundary fill; ``metrics`` holds 0-d tensors (loss, loss_embedding,
    loss_cross, loss_deep). ``use_pallas=False`` is the plain path.
    ``shifts``: the norm5 losses' shift table (12 entries, axis i % 3),
    the targets' by default. ``mesh``: train data-parallel on it (the
    module's docstring).
    """

    def __init__(self, *, criterion=weighted_mse, affs0_weight: float = 1.0,
                 embedding_mode: int = 5, shifts=SHIFTS_3D, use_pallas: bool = True,
                 device_gt: bool = True,
                 device_ema: bool = True, ema_seed: int = 0, ema_intensity: bool = True,
                 ema_mask: bool = True, ema_flip: bool = True, mesh=None):
        self.mesh = mesh
        self.criterion, self.affs0_weight = criterion, affs0_weight
        self.embedding_mode = embedding_mode
        self.shifts = tuple(int(s) for s in shifts)
        self.use_pallas = use_pallas
        self.device_gt = device_gt
        self.device_ema, self.ema_seed = device_ema, ema_seed
        self.ema_flags = dict(intensity=ema_intensity, mask=ema_mask, flip=ema_flip)

    def ema_batch(self, batch: dict, step: int) -> dict:
        """``batch`` with the EMA view and its rules drawn for ``step``."""
        img = batch["image"]
        ema, rules = ema_view_3d(img, ema_generator(self.ema_seed, step, img.device),
                                 **self.ema_flags)
        return dict(batch, ema_image=ema, rules=rules)

    def loss(self, model, batch: dict):
        """(loss, pred, metrics) of a batch that carries ``ema_image`` and
        ``rules``, with the autograd graph; run it under float32_convs."""
        if self.device_gt:
            affs_t, wmap_t, downs = build_targets_3d(batch["seg"])
        else:
            affs_t, wmap_t, downs = batch_targets_3d(batch)
        outs = model(_ncdhw(batch["image"]))
        with torch.no_grad():
            ema = model(_ncdhw(batch["ema_image"]))[4]
        ema = convert_consistency_flip_3d_rule4(_bdhwc(ema), batch["rules"])
        e1, e2, e3, e4, embedding = (_bdhwc(o) for o in outs)

        kw = dict(criterion=self.criterion, affs0_weight=self.affs0_weight)
        if self.embedding_mode == 5:
            full = functools.partial(embedding_loss_norm5, shifts=self.shifts,
                                     use_pallas=self.use_pallas, **kw)
        else:
            full = functools.partial(embedding_loss_norm1, **kw)
        loss_emb, pred = full(embedding, affs_t, wmap_t)
        loss_cross, _ = full(embedding, affs_t, wmap_t, ema_embedding_bdhwc=ema)
        deep = 0.0
        # e1 (1/16) <-> level 4 ... e4 (1/2) <-> level 1
        for emb, (t, w) in zip([e1, e2, e3, e4], downs[::-1]):
            deep = deep + embedding_loss_norm1(emb, t, w, **kw)[0]
        loss = loss_emb + loss_cross + deep
        # the reference's boundary fill: the first slab of each unit-shift
        # channel takes the next one's values
        pred = pred.detach().clone()
        pred[:, 1, :, :1, :] = pred[:, 1, :, 1:2, :]
        pred[:, 2, :, :, :1] = pred[:, 2, :, :, 1:2]
        pred[:, 0, :1, :, :] = pred[:, 0, 1:2, :, :]
        metrics = {"loss": loss.detach(), "loss_embedding": loss_emb.detach(),
                   "loss_cross": loss_cross.detach(), "loss_deep": deep.detach()}
        return loss, torch.relu(pred), metrics

    def grads(self, model, batch: dict):
        """Forward and backward in train mode; the gradients land in
        ``.grad``. Returns (pred, metrics). cuDNN runs its deterministic
        algorithms here: with them and the upsampling's gather backward
        (:mod:`..ops.upsample_cuda`) a step gives the same bits on every run
        on the card, and on the H100 they cost the 3D step nothing
        (``PERF.md``, ``tools/step_determinism.py``). On a mesh the
        gradients are their mean over the ranks."""
        self._train_mode(model)
        with float32_convs(), deterministic_convs():
            loss, pred, metrics = self.loss(model, batch)
            self._backward(model, loss, metrics)
        return pred, metrics


def make_eval_step_2d(offsets, *, criterion=weighted_mse, use_pallas: bool = True):
    """``eval_step(model, batch) -> (loss, pred, embedding, pred_mask)`` in
    eval mode; ``batch`` carries image (B, H, W, 3), affs, wmap, mask;
    ``embedding`` and the mask logits ``pred_mask`` are (B, H, W, C) views.
    With ``use_pallas`` the affinities come from K1f."""
    offsets = [tuple(map(int, o)) for o in offsets]

    @torch.no_grad()
    def eval_step(model, batch: dict):
        model.eval()
        with float32_convs():
            outs = model(_nchw(batch["image"]))
        embedding = _bhwc(outs[4])
        loss, pred = embedding_loss_2d(embedding, batch["affs"], batch["wmap"],
                                       batch["mask"], offsets, criterion=criterion,
                                       use_pallas=use_pallas)
        return loss, torch.relu(pred), embedding, _bhwc(outs[5])

    return eval_step
