"""The 2D train and eval steps (CVPPP).

One train step, as the JAX package's ``make_train_step_2d``:
targets built on the device from the labels; the EMA view drawn on the
device for this step (or taken from the batch); the student forward, then
the EMA view's forward under ``no_grad`` (the JAX step stop-gradients the
teacher), so the BatchNorm running statistics update twice, in that order,
as the JAX step chains them; the teacher's embedding un-flipped; deep
supervision of e4, e3, e2, e1 (1/2 .. 1/16 scale) against the pyramid
levels 1..4 with ``neighbor // 2 * (4 - k)`` offsets; the full-scale self
loss and the cross-view loss; backward; AMSGrad. Every convolution, the
backward ones too, runs in float32 with TF32 off. The model is NCHW; the
losses take its outputs as ``permute(0, 2, 3, 1)`` views with no copy.

The JAX default trains an exact twin of the model in a TPU layout
(``models/resunet2d_s2d.py``); the port has the one model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..data.consistency import IMAGENET_MEAN, IMAGENET_STD, convert_consistency_flip
from ..data.device_aug import ema_generator, ema_view_2d
from ..device import float32_convs
from ..ops.losses import ema_embedding_loss_2d, embedding_loss_2d, weighted_mse
from ..ops.targets import build_targets_2d


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


def _nchw(image_bhwc: torch.Tensor) -> torch.Tensor:
    return image_bhwc.permute(0, 3, 1, 2).contiguous()


def _bhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    return x_nchw.permute(0, 2, 3, 1)


class TrainStep2D:
    """``step(state, batch) -> (pred, metrics)`` updates ``state`` in place.

    ``batch``: tensors on one device, ``image`` (B, H, W, 3) ImageNet-
    normalised (the cvppp pipeline's), ``seg`` (B, H, W) integer labels,
    and, when ``device_ema`` is False, ``ema_image`` and ``rules`` (B, 3).
    ``pred`` is relu of the full-scale affinities (monitoring); ``metrics``
    holds 0-d tensors (loss, loss_embedding, loss_cross[, loss_ct]).

    ``use_pallas=False`` is the plain path. With ``use_pallas`` the
    WeightedMSE loss goes through the loss-fused kernels K2/K3
    (``fuse_loss=True``); the unfused kernel path needs K1b, K4f and K4b
    and raises on CUDA.
    """

    def __init__(self, offsets, *, neighbor: int = 4, criterion=weighted_mse,
                 affs0_weight: float = 1.0, deep_weight=1, self_emb: float = 1.0,
                 cross_emb: float = 1.0, ct_weight: float = 0.0,
                 use_pallas: bool = True, fuse_loss: bool = True,
                 device_ema: bool = True, ema_seed: int = 0,
                 ema_noise: bool = False, ema_blur: bool = False,
                 ema_intensity: bool = True, ema_mask: bool = True,
                 ema_flip: bool = True):
        self.offsets = [tuple(map(int, o)) for o in offsets]
        self.neighbor = neighbor
        self.criterion = criterion
        self.affs0_weight = affs0_weight
        self.dwf = deep_weight_factors(deep_weight)
        self.self_emb, self.cross_emb, self.ct_weight = self_emb, cross_emb, ct_weight
        self.use_pallas, self.fuse_loss = use_pallas, fuse_loss
        self.device_ema, self.ema_seed = device_ema, ema_seed
        self.ema_flags = dict(noise=ema_noise, blur=ema_blur, intensity=ema_intensity,
                              mask=ema_mask, flip=ema_flip)
        self._mean_std: dict = {}

    def _imagenet(self, like: torch.Tensor):
        """(mean, std) on ``like``'s device, made once: a copy from pageable
        host memory would wait for the queued kernels every step."""
        key = (like.device, like.dtype)
        if key not in self._mean_std:
            self._mean_std[key] = tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                                        for a in (IMAGENET_MEAN, IMAGENET_STD))
        return self._mean_std[key]

    def ema_batch(self, batch: dict, step: int) -> dict:
        """``batch`` with the EMA view and its rules drawn for ``step``: the
        view is drawn from the un-normalised image and normalised again."""
        img = batch["image"]
        gen = ema_generator(self.ema_seed, step, img.device)
        mean, std = self._imagenet(img)
        ema, rules = ema_view_2d(img * std + mean, batch["seg"] > 0, gen, **self.ema_flags)
        return dict(batch, ema_image=(ema - mean) / std, rules=rules)

    def loss(self, model, batch: dict):
        """(loss, pred, metrics) of a batch that carries ``ema_image`` and
        ``rules``, with the autograd graph; run it under float32_convs."""
        fused = self.fuse_loss and self.use_pallas and self.criterion is weighted_mse
        if self.use_pallas and not fused and batch["image"].device.type == "cuda":
            raise NotImplementedError(
                "the unfused kernel path (fuse_loss=False or a criterion other "
                "than WeightedMSE) needs K1b, K4f and K4b "
                "(emb2aff_pallas.py:255, :340, :431), which are not ported; use "
                "fuse_loss=True or use_pallas=False")
        offsets, nb_half = self.offsets, self.neighbor // 2
        kw = dict(criterion=self.criterion, use_pallas=self.use_pallas,
                  fuse_loss=self.fuse_loss)
        affs_t, wmap_t, mask_t, downs = build_targets_2d(batch["seg"], offsets,
                                                         neighbor=self.neighbor)
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
        if self.ct_weight:
            lc = torch.mean((embedding - ema) ** 2)
            loss = loss + self.ct_weight * lc
            metrics["loss_ct"] = lc.detach()
        metrics["loss"] = loss.detach()
        return loss, torch.relu(pred.detach()), metrics

    def grads(self, model, batch: dict):
        """Forward and backward in train mode; the gradients land in
        ``.grad``. Returns (pred, metrics)."""
        model.train()
        model.zero_grad(set_to_none=True)
        with float32_convs():
            loss, pred, metrics = self.loss(model, batch)
            loss.backward()
        return pred, metrics

    def __call__(self, state: TrainState, batch: dict):
        if self.device_ema:
            batch = self.ema_batch(batch, state.step)
        pred, metrics = self.grads(state.model, batch)
        state.optimizer.step()
        state.step += 1
        return pred, metrics


def make_eval_step_2d(offsets, *, criterion=weighted_mse, use_pallas: bool = True):
    """``eval_step(model, batch) -> (loss, pred, embedding, mask_logits)`` in
    eval mode; ``batch`` carries image (B, H, W, 3), affs, wmap, mask. With
    ``use_pallas`` the affinities come from K1f."""
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
        return loss, torch.relu(pred), embedding, outs[5]

    return eval_step
