"""Training loop: data -> train step -> validation -> checkpoints.

The port of the JAX package's ``train/loop.py`` for the ``cvppp``,
``bbbc039v1``, ``cvppp_resnet50`` and ``cvppp_resnet101`` (2D) and
``ac3ac4`` (3D) presets. With
``data.device_resident`` (the presets' default, as in JAX) the training set
lives on the device and each step's batch is picked, cropped and augmented
there (:mod:`..data.device_data`); without it, host sample workers feed
batches (copied to the card from pinned memory) from the host samplers
(:func:`build_dataset`), which build the targets and the EMA view on the
host unless ``data.device_gt`` and ``data.device_ema`` leave them to the
step. Each step runs
:class:`.train_step.TrainStep2D` or :class:`.train_step.TrainStep3D`, every
``valid_freq`` steps the validation data is decoded and scored, and every
``save_freq`` steps and at the end a checkpoint is written. 2D validation
decodes each image (K1f affinities, mutex watershed seeded by the labels'
foreground or, with ``train.mask_weight``, by the predicted mask,
small-object merging, relabelling) and scores SBD/DiC/VOI/ARAND, and with
the mask AJI/F1/PQ; 3D validation serves the validation volume tiled (K5f
affinities) through ``train.valid_decoders`` and scores VOI/ARAND and the
affinities' MSE and BCE against the label's. Losses
stay on the device until a display, validation or save point fetches them
in one copy; the watchdog then checks each one. The optimizer is
``train.opt_type``'s (AMSGrad or SGD) at ``train.lr_mode``'s schedule
(:mod:`.optim`); each display logs the rate of its step. The model
computes in ``model.dtype`` (bfloat16: Flax's dtype rule, the losses
float32); the parameters, the optimizer's state and the checkpoints are
float32 either way. Checkpoints are the JAX package's msgpack
(:mod:`.checkpoint`), and ``train.resume`` follows the JAX loop's rule.
Scalars go to ``scalars.jsonl`` and the reference's
``loss.txt``/``valid.txt``.

Data comes through ``data_override=(train, valid)``, the JAX loop's own
hook, or from ``data.data_folder``. With ``data.device_resident``,
``train`` is the packed training set, ``(images, labels)`` numpy arrays as
:func:`..data.device_data.pack_cvppp_arrays` (cvppp),
:func:`..data.device_data.pad_bbbc_arrays` (bbbc039v1) or
:func:`..data.device_data.load_ac3ac4_arrays` (ac3ac4) give them; without
``data_override`` the dataset's loader reads the folder (cv2, or h5py for
AC3/AC4). Without ``data.device_resident`` (or with it, but without
``device_gt`` and ``device_ema``, where the JAX loop also takes the host
sampler), ``train.sample(rng)`` gives ``{"image": (H, W, 3) float32,
ImageNet-normalised for cvppp and in [0, 1] for bbbc039v1, "seg": (H, W)
int}`` (2D) or ``{"image": (D, H, W, 1) float32 in [0, 1], "seg": (D, H,
W) int}`` (3D), with the targets and the EMA view that ``device_gt`` and
``device_ema`` leave to the host (:class:`..data.cvppp.CVPPPTrain`,
:class:`..data.bbbc.BBBCTrain`, :class:`..data.ac3ac4.AC3AC4Train`, which
:func:`build_dataset` builds on ``data.data_folder``). ``valid`` is a list (or
indexable) of 2D samples (``CVPPPValidation``, ``BBBCValidation``), or a
volume with ``raw`` (D, H, W) float32 in [0, 1] and ``label`` (D, H, W)
int (:class:`..data.AC3AC4ValidVolume`).
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
from ..metrics import (abs_diff_fg_labels, adapted_rand_error, agg_jc_index, get_fast_pq,
                       pixel_f1, remap_label, symmetric_best_dice, voi)
from ..models import ARCHS_2D, model_from_config
from ..ops import multi_offset, relabel
from ..ops.losses import CRITERIA, mask_head_loss
from ..ops.targets import gen_affs, seg_to_aff_3d_12ch, weight_binary_ratio
from ..postproc import merge_func, remove_small_object, seg_mutex
from ..utils.guards import LossWatchdog
from ..utils.show import val_show
from .checkpoint import latest_checkpoint, load_checkpoint, restore, save_checkpoint
from .optim import make_optimizer
from .train_step import TrainState, TrainStep2D, TrainStep3D, make_eval_step_2d

ARCHS_3D = ("unet_pni_deep",)
DATASETS = ("cvppp", "bbbc039v1", "ac3ac4")
LOSS_MODES = ("affinity", "discriminative")
# why neither package trains MALA
MALA_NOT_TRAINED = (
    "unet3d_mala is not trained: the 3D train step reads the five outputs and the "
    "BatchNorm statistics of unet_pni_deep, and MALA returns one embedding and has no "
    "BatchNorm (the JAX package's step cannot train it either)")

log = logging.getLogger("pea")


def check_train_config(cfg: Config):
    """Raise NotImplementedError for the options whose code is not ported."""
    if cfg.model.arch == "unet3d_mala":
        raise NotImplementedError(MALA_NOT_TRAINED)
    not_ported = []
    if cfg.model.arch not in ARCHS_2D + ARCHS_3D:
        not_ported.append(f"model.arch={cfg.model.arch!r}")
    if cfg.train.loss_mode not in LOSS_MODES:
        not_ported.append(f"train.loss_mode={cfg.train.loss_mode!r}")
    resolve_compute_dtype(cfg.model)  # raises on a dtype that is not served
    if cfg.train.loss_func not in CRITERIA:
        not_ported.append(f"train.loss_func={cfg.train.loss_func!r}")
    if cfg.data.dataset not in DATASETS:
        not_ported.append(f"data.dataset={cfg.data.dataset!r}")
    if not_ported:
        raise NotImplementedError("not ported: " + "; ".join(not_ported))


def uses_resident_sampler(cfg: Config) -> bool:
    """The JAX loop's rule: the device-resident sampler with
    ``data.device_resident``, ``device_gt`` and ``device_ema`` together."""
    d = cfg.data
    return bool(d.device_resident and d.device_gt and d.device_ema)


def build_dataset(cfg: Config, decoded=None):
    """(host training sampler, validation set) of ``cfg.data.dataset`` on
    ``data.data_folder``, as the JAX loop's ``build_dataset``: the sampler
    builds targets on the host unless ``device_gt`` (``light``), and the EMA
    view unless ``device_ema``. ``decoded=(train, valid)`` stands in for the
    files: CVPPP's and BBBC's (image, label) pairs as
    :func:`..data.cvppp.decoded_split` and :func:`..data.bbbc.decoded_pairs`
    give them, AC3/AC4's (raw, label) volumes (the training volume, and the
    one whose last 20 slices validate)."""
    d, seed = cfg.data, cfg.train.random_seed
    train_in, valid_in = decoded if decoded is not None else (None, None)
    if d.dataset == "cvppp":
        from ..data.cvppp import CVPPPTrain, CVPPPValidation

        return (CVPPPTrain(d.data_folder, size=d.size, shifts=tuple(d.shifts),
                           neighbor=d.neighbor, padding=d.padding,
                           separate_weight=d.separate_weight, valid_set=d.valid_set,
                           ema_noise=d.if_ema_noise, ema_blur=d.if_ema_blur,
                           ema_intensity=d.if_ema_intensity, ema_mask=d.if_ema_mask,
                           ema_flip=d.if_ema_flip, light=d.device_gt,
                           device_ema=d.device_ema, seed=seed, pairs=train_in),
                CVPPPValidation(d.data_folder, valid_set=d.valid_set, padding=d.padding,
                                pairs=valid_in))
    if d.dataset == "bbbc039v1":
        from ..data.bbbc import BBBCTrain, BBBCValidation

        return (BBBCTrain(d.data_folder, size=d.size, padding=d.bbbc_padding,
                          shifts=tuple(d.shifts), neighbor=d.neighbor, light=d.device_gt,
                          device_ema=d.device_ema, seed=seed, pairs=train_in),
                BBBCValidation(d.data_folder, shifts=tuple(d.shifts), neighbor=d.neighbor,
                               pairs=valid_in))
    from ..data.ac3ac4 import AC3AC4Train, AC3AC4ValidVolume

    return (AC3AC4Train(d.data_folder, dataset_name=d.dataset_name, train_split=d.train_split,
                        crop_size=tuple(d.crop_size), padding=d.padding_3d,
                        light=d.device_gt, device_ema=d.device_ema, seed=seed,
                        arrays=train_in),
            AC3AC4ValidVolume(d.data_folder, dataset_name=d.dataset_name, mode="valid",
                              arrays=valid_in))


def load_resident_data(cfg: Config):
    """(training arrays, validation set) of ``cfg.data.dataset`` read from
    ``data.data_folder``: cv2 for CVPPP and BBBC, h5py for AC3/AC4."""
    from ..data import device_data as dd

    d = cfg.data
    if d.dataset == "cvppp":
        from ..data.cvppp import CVPPPValidation

        return (dd.load_cvppp_arrays(d.data_folder, d.valid_set, d.padding),
                CVPPPValidation(d.data_folder, valid_set=d.valid_set, padding=d.padding))
    if d.dataset == "bbbc039v1":
        from ..data.bbbc import BBBCValidation

        return (dd.load_bbbc_arrays(d.data_folder, d.bbbc_padding),
                BBBCValidation(d.data_folder, shifts=tuple(d.shifts), neighbor=d.neighbor))
    from ..data.ac3ac4 import AC3AC4ValidVolume

    return (dd.load_ac3ac4_arrays(d.data_folder, d.dataset_name, d.train_split,
                                  crop_z=d.crop_size[0]),
            AC3AC4ValidVolume(d.data_folder, dataset_name=d.dataset_name, mode="valid"))


def resident_sampler(cfg: Config, arrays, device):
    """The training arrays uploaded to ``device`` once, and next_batch(step):
    the dataset's device sampler, its draws from ``sampler_generator(seed,
    step)``, so a resumed run draws the batches an uninterrupted run drew."""
    from ..data import device_data as dd

    d, b = cfg.data, cfg.train.batch_size
    images, labels = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
    if d.dataset == "cvppp":
        def draw(gen):
            return dd.sample_cvppp_batch(images, labels, gen, b, out=d.size)
    elif d.dataset == "bbbc039v1":
        def draw(gen):
            return dd.sample_bbbc_batch(images, labels, gen, b, size=d.size,
                                        padding=d.bbbc_padding)
    else:
        def draw(gen):
            return dd.sample_ac3ac4_batch(images, labels, gen, b, crop_size=tuple(d.crop_size),
                                          padding=d.padding_3d)

    def next_batch(step: int) -> dict:
        return draw(dd.sampler_generator(cfg.train.random_seed, step))

    return next_batch


def make_train_step(cfg: Config):
    """The train step of a config, as :func:`train` runs it: 3D for the
    PNI arch, else 2D, with the config's loss, kernels (``use_pallas``),
    and targets and EMA view on the device or from the batch
    (``data.device_gt``, ``data.device_ema``)."""
    d, t = cfg.data, cfg.train
    ema_flags = dict(ema_seed=t.random_seed, ema_intensity=d.if_ema_intensity,
                     ema_mask=d.if_ema_mask, ema_flip=d.if_ema_flip)
    if cfg.model.arch in ARCHS_3D:
        return TrainStep3D(criterion=CRITERIA[t.loss_func], affs0_weight=t.affs0_weight,
                           embedding_mode=t.embedding_mode, use_pallas=t.use_pallas,
                           device_gt=d.device_gt, device_ema=d.device_ema, **ema_flags)
    return TrainStep2D(
        multi_offset(list(d.shifts), neighbor=d.neighbor), neighbor=d.neighbor,
        criterion=CRITERIA[t.loss_func], affs0_weight=t.affs0_weight,
        deep_weight=t.deep_weight, self_emb=t.self_emb, cross_emb=t.cross_emb,
        mask_weight=t.mask_weight, ct_weight=t.ct_weight, loss_mode=t.loss_mode,
        disc_weight=t.disc_weight, use_pallas=t.use_pallas,
        fuse_loss=t.fuse_loss, imagenet_norm=d.dataset == "cvppp", device_gt=d.device_gt,
        device_ema=d.device_ema, ema_noise=d.if_ema_noise, ema_blur=d.if_ema_blur,
        **ema_flags)


def init_state(cfg: Config, device) -> TrainState:
    """Model in the compute dtype (``model.dtype``) with float32 weights
    drawn from ``train.random_seed`` (on the CPU, so the draw is the same
    whatever the device), and a fresh optimizer (``train.opt_type`` at
    ``train.lr_mode``'s schedule)."""
    dtype = resolve_compute_dtype(cfg.model)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.train.random_seed)
        model = model_from_config(cfg.model, dtype)
    model = model.to(device).train()
    return TrainState(model, make_optimizer(model.parameters(), cfg.train), 0)


def validate_2d(cfg: Config, eval_step, state: TrainState, valid_dataset, offsets,
                device, iters: int = 0, show_dir: str | None = None) -> dict:
    """Decode and score the validation set; targets are built on the
    device. With ``train.mask_weight`` (BBBC), as the JAX loop: the loss
    adds the mask head's, the decode is seeded by argmax(softmax(mask
    logits)) > 0 with components under 25 pixels dropped, the small-object
    merging takes the bbbc schedule, and AJI/F1/PQ are scored on
    ``remap_label``-ed labels, 0.0 when either is empty. In bfloat16 the
    eval step's K1f takes the bfloat16 embedding and the softmax the
    bfloat16 logits, as in the JAX loop; the host gets them widened to
    float32, exactly. With ``show_dir``, the first image's montage
    (:func:`..utils.show.val_show`: the last affinity channel predicted and
    targeted, the decoded and true labels) goes to
    ``<show_dir>/<iters:06d>.png``, as the JAX loop writes it."""
    dev = torch.device(device)
    bbbc = bool(cfg.train.mask_weight)
    scores: dict = {}
    for i in range(len(valid_dataset)):
        s = valid_dataset[i]
        seg_t = torch.from_numpy(np.asarray(s["seg"], np.int64)[None]).to(dev)
        affs, mask = gen_affs(seg_t, offsets)
        batch = {"image": torch.from_numpy(np.ascontiguousarray(s["image"][None])).to(dev),
                 "affs": affs, "wmap": weight_binary_ratio(affs), "mask": mask}
        loss, pred, _, pred_mask = eval_step(state.model, batch)
        loss = float(loss)
        out_affs = pred[0].float().cpu().numpy()
        gt = np.asarray(s["seg"]).astype(np.uint16)
        if bbbc:
            loss += cfg.train.mask_weight * float(mask_head_loss(pred_mask, seg_t > 0))
            prob = torch.softmax(pred_mask[0], dim=-1).float().cpu().numpy()
            fg = remove_small_object((np.argmax(prob, axis=-1) > 0).astype(np.uint8),
                                     min_size=25)
        else:
            fg = (gt > 0).astype(np.uint8)
        seg = seg_mutex(out_affs, offsets=offsets, strides=list(cfg.data.strides),
                        mask=fg).astype(np.uint16)
        seg = merge_func(seg, variant="bbbc" if bbbc else "cvppp")
        seg = relabel(seg).astype(np.uint16)
        vs, vm = voi(gt, seg)
        m = {"loss": loss, "SBD": symmetric_best_dice(seg, gt),
             "DiC": abs_diff_fg_labels(seg, gt), "VOI": vs + vm,
             "ARAND": adapted_rand_error(gt, seg)[0]}
        if bbbc:
            gtr, pr = remap_label(gt.astype(np.int64)), remap_label(seg.astype(np.int64))
            empty = pr.max() == 0 or gtr.max() == 0
            m["AJI"] = 0.0 if empty else agg_jc_index(gtr, pr)
            m["F1"] = 0.0 if empty else pixel_f1(gtr, pr)
            m["PQ"] = 0.0 if empty else get_fast_pq(gtr, pr)[0][2]
        for k, v in m.items():
            scores.setdefault(k, []).append(float(v))
        if i == 0 and show_dir is not None:
            val_show(iters, out_affs[-1], affs[0, -1].float().cpu().numpy(), seg, gt, show_dir)
    return {f"valid/{k}": float(np.mean(v)) for k, v in scores.items()}


def valid_geometry_3d(crop_size) -> tuple:
    """(stride, padding) of the in-loop 3D validation's tiles, the JAX
    loop's: stride (cz - 8, cy / 2, cx / 2) and padding (min(4, cz / 4),
    min(48, cy / 4), min(48, cx / 4)), so (10, 80, 80) and (4, 40, 40) at
    (18, 160, 160)."""
    cz, cy, cx = crop_size
    return ((max(cz - 8, 1), cy // 2, cx // 2),
            (min(4, cz // 4), min(48, cy // 4), min(48, cx // 4)))


def validate_3d(cfg: Config, state: TrainState, valid_volume, device) -> dict:
    """Serve the validation volume tiled with the trained weights, decode it
    with ``train.valid_decoders`` and score it: VOI/ARAND per decoder, and
    the affinities' MSE and BCE (p clipped to [1e-6, 1 - 1e-6]) against the
    label's 12-channel targets. Tiles: :func:`valid_geometry_3d`. The
    volume is served as :func:`..infer.run_inference_3d` serves it, as the
    JAX loop's validation is: the predictor of ``model.fast_tiled_infer``,
    the embedding cast to float32 before K5f in bfloat16 too."""
    from ..infer.inference3d import run_inference_3d

    stride, padding = valid_geometry_3d(cfg.data.crop_size)
    affs, results = run_inference_3d(
        cfg, state.model.state_dict(), valid_volume.raw, gt=valid_volume.label,
        decoders=tuple(cfg.train.valid_decoders), crop_size=tuple(cfg.data.crop_size),
        stride=stride, padding=padding, device=device)
    out = {f"valid/{dec}_{k}": float(v) for dec, (_, m) in results.items() for k, v in m.items()}
    label = torch.from_numpy(np.asarray(valid_volume.label, np.int64)[None])
    gt = seg_to_aff_3d_12ch(label)[0].numpy()
    out["valid/affs_mse"] = float(np.mean((affs - gt) ** 2))
    p = np.clip(affs, 1e-6, 1 - 1e-6)
    out["valid/affs_bce"] = float(np.mean(-(gt * np.log(p) + (1 - gt) * np.log(1 - p))))
    return out


def _has_valid(valid) -> bool:
    return valid is not None and (hasattr(valid, "raw") or len(valid) > 0)


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
    receives per-step host seconds, ``data_s`` (batch wait and device copy,
    or the device sampler's launches) and ``step_s`` (the step, synchronised
    after it: timing costs the overlap of one step's host work with the
    previous step's kernels), ``valid_s``, the seconds of each validation,
    and ``lr``, the rate of each step.
    """
    check_train_config(cfg)
    dev = resolve_device(device)
    is_3d = cfg.model.arch in ARCHS_3D
    resident = uses_resident_sampler(cfg)
    if cfg.data.device_resident and not resident:
        log.info("device_resident needs data.device_gt and data.device_ema; "
                 "using the host sampler")
    if data_override is not None:
        train_ds, valid_ds = data_override
    elif resident:
        train_ds, valid_ds = load_resident_data(cfg)
    else:
        train_ds, valid_ds = build_dataset(cfg)
    if resident and not (isinstance(train_ds, (tuple, list)) and len(train_ds) == 2):
        raise TypeError("with data.device_resident the training set is an (images, labels) "
                        "pair of arrays; a dataset with .sample() trains with "
                        "data.device_resident=False")
    if not resident and not hasattr(train_ds, "sample"):
        raise TypeError("the host sampler's training set is a dataset with .sample(rng); "
                        "an (images, labels) pair trains with data.device_resident, "
                        "data.device_gt and data.device_ema")
    total_iters = max_iters or cfg.train.total_iters
    state = init_state(cfg, dev)
    save_path = os.path.join(cfg.save_path, cfg.name)
    if cfg.train.resume:
        ck = latest_checkpoint(save_path)
        if ck:
            # an optimizer state that does not fit the chain: a warning, a fresh one
            restore(state, load_checkpoint(ck))
            log.info("resumed from %s", ck)

    step_fn = make_train_step(cfg)
    if is_3d:
        def validate(it):
            return validate_3d(cfg, state, valid_ds, dev)
    else:
        offsets = step_fn.offsets
        eval_step = make_eval_step_2d(offsets, criterion=step_fn.criterion,
                                      use_pallas=cfg.train.use_pallas)

        def validate(it):
            return validate_2d(cfg, eval_step, state, valid_ds, offsets, dev, iters=it,
                               show_dir=os.path.join(save_path, "valid"))

    if resident:
        provider = None
        next_batch = resident_sampler(cfg, train_ds, dev)
    else:
        provider = Provider(train_ds, batch_size=cfg.train.batch_size,
                            num_workers=cfg.train.num_workers, seed=cfg.train.random_seed)

        def next_batch(step: int) -> dict:
            return to_device(provider.next(), dev)
    logger = ScalarLogger(log_dir or os.path.join(save_path, "log"))
    watchdog = LossWatchdog(save_dir=save_path)
    history: list = []
    pending: list = []
    sum_loss = 0.0
    t_start = time.time()
    it = state.step
    display_freq, valid_freq, save_freq = (
        cfg.train.display_freq, cfg.train.valid_freq, cfg.train.save_freq)

    opt, group = state.optimizer, state.optimizer.param_groups[0]

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
            batch = next_batch(it)
            t1 = time.perf_counter()
            lr = opt.lr(group)
            _, metrics = step_fn(state, batch)
            it += 1
            pending.append(metrics["loss"])
            if timing is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timing.setdefault("data_s", []).append(t1 - t0)
                timing.setdefault("step_s", []).append(time.perf_counter() - t1)
                timing.setdefault("lr", []).append(lr)

            if it % display_freq == 0 or it <= 1:
                drain()
                dt = time.time() - t_start
                avg = sum_loss / (display_freq if it > 1 else max(it, 1))
                log.info("step %d, loss=%.6f (%.2f s)", it, avg, dt)
                logger.add(it, loss=avg, lr=lr, sec_per_iter=dt / max(it, 1))
                sum_loss = 0.0
            if cfg.train.if_valid and _has_valid(valid_ds) and it % valid_freq == 0 and it > 1:
                drain()
                t0 = time.perf_counter()
                m = validate(it)
                if timing is not None:
                    timing.setdefault("valid_s", []).append(time.perf_counter() - t0)
                log.info("valid @%d: %s", it, m)
                logger.add(it, **m)
                history.append({"step": it, **m})
            if (it % save_freq == 0 and it > 1) or it >= total_iters:
                drain()
                save_checkpoint(save_path, state, it)
        drain()
    finally:
        if provider is not None:
            provider.close()
        logger.close()
    return state, history
