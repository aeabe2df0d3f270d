"""Training loop (2D, CVPPP): data -> train step -> validation -> checkpoints.

The port of the JAX package's ``train/loop.py`` for the ``cvppp`` preset:
host sample workers feed batches (copied to the card from pinned memory),
each step runs :class:`.train_step.TrainStep2D`, every ``valid_freq``
steps the validation set is decoded (K1f affinities, mutex watershed,
small-object merging, relabelling) and scored (SBD/DiC/VOI/ARAND), and
every ``save_freq`` steps and at the end a checkpoint is written. Losses
stay on the device until a display, validation or save point fetches them
in one copy; the watchdog then checks each one. Scalars go to
``scalars.jsonl`` and the reference's ``loss.txt``/``valid.txt``.

Data comes through ``data_override=(train_dataset, valid_samples)``, the
JAX loop's own hook: ``train_dataset.sample(rng) -> {"image": (H, W, 3)
ImageNet-normalised float32, "seg": (H, W) int}`` and a list (or indexable)
of such samples for validation. The CVPPP disk sampler and the
device-resident sampler are not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..config import Config, resolve_compute_dtype
from ..data.provider import Provider, to_device
from ..device import resolve_device
from ..metrics import abs_diff_fg_labels, adapted_rand_error, symmetric_best_dice, voi
from ..models import ResidualUNet2DDeep
from ..ops import multi_offset, relabel
from ..ops.losses import CRITERIA
from ..ops.targets import gen_affs, weight_binary_ratio
from ..postproc import merge_func, seg_mutex
from ..utils.guards import LossWatchdog
from .checkpoint import latest_checkpoint, load_checkpoint, restore, save_checkpoint
from .optim import AMSGrad
from .train_step import TrainState, TrainStep2D, make_eval_step_2d

log = logging.getLogger("pea")


def check_train_config(cfg: Config):
    """Raise NotImplementedError for the options whose code is not ported."""
    not_ported = []
    if cfg.model.arch != "resunet2d_deep":
        not_ported.append(f"model.arch={cfg.model.arch!r}")
    if resolve_compute_dtype(cfg.model) != "float32":
        not_ported.append(f"model.dtype={cfg.model.dtype!r} (float32 only)")
    if cfg.train.lr_mode != "fixed":
        not_ported.append(f"train.lr_mode={cfg.train.lr_mode!r} (fixed only)")
    if cfg.train.loss_func not in CRITERIA:
        not_ported.append(f"train.loss_func={cfg.train.loss_func!r}")
    if cfg.train.mask_weight:
        not_ported.append("train.mask_weight (the mask-head loss)")
    if not (cfg.data.device_gt and cfg.data.device_ema):
        not_ported.append("host-built targets or EMA views (data.device_gt/device_ema)")
    if cfg.data.if_ema_noise or cfg.data.if_ema_blur:
        not_ported.append("the EMA view's noise/blur (data.if_ema_noise/if_ema_blur)")
    if cfg.data.device_resident:
        not_ported.append("the device-resident sampler (data.device_resident)")
    if not_ported:
        raise NotImplementedError("not ported: " + "; ".join(not_ported))


def init_state(cfg: Config, device) -> TrainState:
    """Model with weights drawn from ``train.random_seed`` (on the CPU, so
    the draw is the same whatever the device), and a fresh AMSGrad."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.random_seed)
        model = ResidualUNet2DDeep(cfg.model.input_nc, cfg.model.output_nc,
                                   tuple(cfg.model.filters), cfg.model.emd)
    model = model.to(device).train()
    opt = AMSGrad(model.parameters(), lr=cfg.train.base_lr, eps=0.01,
                  weight_decay=cfg.train.weight_decay or 0.0)
    return TrainState(model, opt, 0)


def validate_2d(cfg: Config, eval_step, state: TrainState, valid_dataset, offsets,
                device) -> dict:
    """Decode and score the validation set; targets are built on the device."""
    dev = torch.device(device)
    losses, dices, diffs, vois, arands = [], [], [], [], []
    for i in range(len(valid_dataset)):
        s = valid_dataset[i]
        seg_t = torch.from_numpy(np.asarray(s["seg"], np.int64)[None]).to(dev)
        affs, mask = gen_affs(seg_t, offsets)
        batch = {"image": torch.from_numpy(np.ascontiguousarray(s["image"][None])).to(dev),
                 "affs": affs, "wmap": weight_binary_ratio(affs), "mask": mask}
        loss, pred, _, _ = eval_step(state.model, batch)
        out_affs = pred[0].cpu().numpy()
        gt = np.asarray(s["seg"]).astype(np.uint16)
        fg = (gt > 0).astype(np.uint8)
        seg = seg_mutex(out_affs, offsets=offsets, strides=list(cfg.data.strides),
                        mask=fg).astype(np.uint16)
        seg = relabel(merge_func(seg)).astype(np.uint16)
        losses.append(float(loss))
        dices.append(symmetric_best_dice(seg, gt))
        diffs.append(abs_diff_fg_labels(seg, gt))
        vs, vm = voi(gt, seg)
        vois.append(vs + vm)
        arands.append(adapted_rand_error(gt, seg)[0])
    return {"valid/loss": float(np.mean(losses)),
            "valid/SBD": float(np.mean(dices)),
            "valid/DiC": float(np.mean(diffs)),
            "valid/VOI": float(np.mean(vois)),
            "valid/ARAND": float(np.mean(arands))}


class ScalarLogger:
    """scalars.jsonl, plus the reference's loss.txt / valid.txt."""

    def __init__(self, record_path: str):
        os.makedirs(record_path, exist_ok=True)
        self.dir = record_path
        self.f = open(os.path.join(record_path, "scalars.jsonl"), "a")

    def add(self, step: int, **scalars):
        self.f.write(json.dumps({"step": step, **scalars}) + "\n")
        self.f.flush()
        fname = "valid.txt" if any(k.startswith("valid") for k in scalars) else "loss.txt"
        with open(os.path.join(self.dir, fname), "a") as f:
            parts = ", ".join(f"{k} = {v:.6f}" for k, v in scalars.items())
            f.write(f"step = {step}, {parts}\n")

    def close(self):
        self.f.close()


def train(cfg: Config, max_iters: int | None = None, data_override=None,
          device=None, log_dir: str | None = None, timing: dict | None = None):
    """Train; returns (state, history of validation results).

    ``device``: CUDA unless "cpu" is asked for. ``timing``, when given,
    receives per-step host seconds, ``data_s`` (batch wait and device copy)
    and ``step_s`` (the step, synchronised after it: timing costs the
    overlap of one step's host work with the previous step's kernels).
    """
    check_train_config(cfg)
    if data_override is None:
        raise NotImplementedError(
            "the CVPPP disk sampler (cv2) is not ported; pass "
            "data_override=(train_dataset, valid_samples)")
    dev = resolve_device(device)
    train_ds, valid_ds = data_override
    total_iters = max_iters or cfg.train.total_iters
    state = init_state(cfg, dev)
    save_path = os.path.join(cfg.save_path, cfg.name)
    if cfg.train.resume:
        ck = latest_checkpoint(save_path)
        if ck:
            restore(state, load_checkpoint(ck))
            log.info("resumed from %s", ck)

    offsets = multi_offset(list(cfg.data.shifts), neighbor=cfg.data.neighbor)
    criterion = CRITERIA[cfg.train.loss_func]
    step_fn = TrainStep2D(
        offsets, neighbor=cfg.data.neighbor, criterion=criterion,
        affs0_weight=cfg.train.affs0_weight, deep_weight=cfg.train.deep_weight,
        self_emb=cfg.train.self_emb, cross_emb=cfg.train.cross_emb,
        ct_weight=cfg.train.ct_weight, use_pallas=cfg.train.use_pallas,
        fuse_loss=cfg.train.fuse_loss, device_ema=True,
        ema_seed=cfg.train.random_seed, ema_noise=cfg.data.if_ema_noise,
        ema_blur=cfg.data.if_ema_blur, ema_intensity=cfg.data.if_ema_intensity,
        ema_mask=cfg.data.if_ema_mask, ema_flip=cfg.data.if_ema_flip)
    eval_step = make_eval_step_2d(offsets, criterion=criterion,
                                  use_pallas=cfg.train.use_pallas)

    provider = Provider(train_ds, batch_size=cfg.train.batch_size,
                        num_workers=cfg.train.num_workers, seed=cfg.train.random_seed)
    logger = ScalarLogger(log_dir or os.path.join(save_path, "log"))
    watchdog = LossWatchdog(save_dir=save_path)
    history: list = []
    pending: list = []
    sum_loss = 0.0
    t_start = time.time()
    it = state.step
    display_freq, valid_freq, save_freq = (
        cfg.train.display_freq, cfg.train.valid_freq, cfg.train.save_freq)

    def drain():
        nonlocal sum_loss
        if not pending:
            return
        vals = torch.stack(pending).cpu().tolist()
        for j, v in enumerate(vals):
            watchdog.check(v, state=None, step=it - len(vals) + 1 + j)
            sum_loss += v
        pending.clear()

    try:
        while it < total_iters:
            t0 = time.perf_counter()
            batch = to_device(provider.next(), dev)
            t1 = time.perf_counter()
            _, metrics = step_fn(state, batch)
            it += 1
            pending.append(metrics["loss"])
            if timing is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timing.setdefault("data_s", []).append(t1 - t0)
                timing.setdefault("step_s", []).append(time.perf_counter() - t1)

            if it % display_freq == 0 or it <= 1:
                drain()
                dt = time.time() - t_start
                avg = sum_loss / (display_freq if it > 1 else max(it, 1))
                log.info("step %d, loss=%.6f (%.2f s)", it, avg, dt)
                logger.add(it, loss=avg, sec_per_iter=dt / max(it, 1))
                sum_loss = 0.0
            if cfg.train.if_valid and valid_ds is not None and len(valid_ds) > 0 \
                    and it % valid_freq == 0 and it > 1:
                drain()
                m = validate_2d(cfg, eval_step, state, valid_ds, offsets, dev)
                log.info("valid @%d: %s", it, m)
                logger.add(it, **m)
                history.append({"step": it, **m})
            if (it % save_freq == 0 and it > 1) or it >= total_iters:
                drain()
                save_checkpoint(save_path, state, it)
        drain()
    finally:
        provider.close()
        logger.close()
    return state, history
