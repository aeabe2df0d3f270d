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
``save_freq`` steps and at the end a checkpoint is written. With
``train.steps_per_call`` S > 1 each step past the first replays a CUDA
graph of the step (:mod:`.graph_step`), S steps a call. 2D validation
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

Data parallelism (``mesh``, world size N > 1; ``--distributed`` in the
CLI): one process per card, ``train.batch_size`` the global batch, which
must divide by N. Rank 0's parameters and buffers are broadcast at the
start (after a resume too, which every rank reads). The device-resident
sampler draws the global batch on every rank and the step trains on the
rank's shard (:mod:`.train_step`), so N ranks train on the one-process
run's batches. The host sampler draws ``batch_size / N`` samples a rank,
its workers seeded per rank; the ranks' batches, gathered in rank order,
are the global batch. Rank 0 alone validates, logs and writes checkpoints;
the other ranks wait for it.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..config import Config, resolve_compute_dtype
from ..data.provider import Provider, device_prefetch
from ..device import resolve_device
from ..metrics import (abs_diff_fg_labels, adapted_rand_error, agg_jc_index, get_fast_pq,
                       pixel_f1, remap_label, symmetric_best_dice, voi)
from ..models import ARCHS_2D, model_from_config
from ..ops import multi_offset, relabel
from ..ops.losses import CRITERIA, mask_head_loss
from ..ops.targets import gen_affs, seg_to_aff_3d_12ch, weight_binary_ratio
from ..parallel.mesh import all_gather_batch, barrier, broadcast_module_
from ..postproc import merge_func, remove_small_object, seg_mutex
from ..utils.guards import LossWatchdog
from ..utils.profiling import span
from ..utils.show import val_show
from .checkpoint import latest_checkpoint, load_checkpoint, restore, save_checkpoint
from .graph_step import GraphedStep
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
    ``data.device_resident``, ``device_gt`` and ``device_ema`` together,
    and for cvppp only with the "xiaoyu" augmentation: a data config that
    carries ``aug_mode``, which no field of either package's config does,
    may choose the host sampler's "rsis" branch, as in the JAX loop
    (:func:`build_dataset` gives it to ``CVPPPTrain``)."""
    d = cfg.data
    chain_ok = d.dataset != "cvppp" or getattr(d, "aug_mode", "xiaoyu") == "xiaoyu"
    return bool(d.device_resident and d.device_gt and d.device_ema and chain_ok)


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
                           aug_mode=getattr(d, "aug_mode", "xiaoyu"),
                           ema_noise=d.if_ema_noise, ema_blur=d.if_ema_blur,
                           ema_intensity=d.if_ema_intensity, ema_mask=d.if_ema_mask,
                           ema_flip=d.if_ema_flip, light=d.device_gt,
                           device_ema=d.device_ema, seed=seed, pairs=train_in),
                CVPPPValidation(d.data_folder, shifts=tuple(d.shifts), neighbor=d.neighbor,
                                valid_set=d.valid_set, padding=d.padding, pairs=valid_in))
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
                CVPPPValidation(d.data_folder, shifts=tuple(d.shifts), neighbor=d.neighbor,
                                valid_set=d.valid_set, padding=d.padding))
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
        with span("pea.sample"):
            return draw(dd.sampler_generator(cfg.train.random_seed, step))

    return next_batch


def make_train_step(cfg: Config, mesh=None):
    """The train step of a config, as :func:`train` runs it: 3D for the
    PNI arch, else 2D, with the config's loss, kernels (``use_pallas``),
    and targets and EMA view on the device or from the batch
    (``data.device_gt``, ``data.device_ema``), data-parallel on ``mesh``."""
    d, t = cfg.data, cfg.train
    ema_flags = dict(ema_seed=t.random_seed, ema_intensity=d.if_ema_intensity,
                     ema_mask=d.if_ema_mask, ema_flip=d.if_ema_flip, mesh=mesh)
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


def validate_3d(cfg: Config, state: TrainState, valid_volume, device, decoders=None,
                crop_size=None, stride=None, padding=None) -> dict:
    """Serve the validation volume tiled with the trained weights, decode it
    with ``decoders`` and score it: VOI/ARAND per decoder, and the
    affinities' MSE and BCE (p clipped to [1e-6, 1 - 1e-6]) against the
    label's 12-channel targets. Tiles of ``crop_size`` at ``stride`` over
    the volume padded by ``padding``. Left None, as the training loop
    calls it, the decoders are ``train.valid_decoders``, the tiles
    ``data.crop_size`` and the stride and padding
    :func:`valid_geometry_3d`'s. The volume is served as
    :func:`..infer.run_inference_3d` serves it, as the JAX loop's
    validation is: the predictor of ``model.fast_tiled_infer``, the
    embedding cast to float32 before K5f in bfloat16 too."""
    from ..infer.inference3d import run_inference_3d

    crop_size = tuple(cfg.data.crop_size if crop_size is None else crop_size)
    geometry = valid_geometry_3d(crop_size)
    stride = geometry[0] if stride is None else tuple(stride)
    padding = geometry[1] if padding is None else tuple(padding)
    decoders = tuple(cfg.train.valid_decoders if decoders is None else decoders)
    affs, results = run_inference_3d(
        cfg, state.model.state_dict(), valid_volume.raw, gt=valid_volume.label,
        decoders=decoders, crop_size=crop_size, stride=stride, padding=padding,
        device=device)
    out = {f"valid/{dec}_{k}": float(v) for dec, (_, m) in results.items() for k, v in m.items()}
    label = torch.from_numpy(np.asarray(valid_volume.label, np.int64)[None])
    gt = seg_to_aff_3d_12ch(label)[0].numpy()
    out["valid/affs_mse"] = float(np.mean((affs - gt) ** 2))
    p = np.clip(affs, 1e-6, 1 - 1e-6)
    out["valid/affs_bce"] = float(np.mean(-(gt * np.log(p) + (1 - gt) * np.log(1 - p))))
    return out


def call_freqs(tc) -> tuple:
    """(display, valid, save) frequencies of a TrainConfig rounded up to
    multiples of ``steps_per_call``, as the JAX loop rounds them, so that
    events land on call boundaries; the config is left as it is."""
    s = max(1, int(tc.steps_per_call))
    return tuple(-(-f // s) * s for f in (tc.display_freq, tc.valid_freq, tc.save_freq))


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
          device=None, log_dir: str | None = None, timing: dict | None = None,
          mesh=None):
    """Train; returns (state, history of validation results).

    ``device``: CUDA unless "cpu" is asked for. ``mesh``
    (:mod:`..parallel.mesh`): train data-parallel over its ranks, on its
    device (the module's docstring); the history is rank 0's. ``timing``,
    when given, receives per-step host seconds, ``data_s`` (batch wait and device copy,
    or the device sampler's launches) and ``step_s`` (the step, synchronised
    after it: timing costs the overlap of one step's host work with the
    previous step's kernels), ``valid_s``, the seconds of each validation,
    ``lr``, the rate of each step, ``loss``, each step's loss (as the
    display, validation and save points fetch them), and with a captured
    graph ``capture_s``, the capture's seconds.

    ``train.steps_per_call`` S > 1 runs the JAX loop's calls of S steps:
    each step's batch and EMA view are drawn eagerly, and the rest of the
    step is a replay of one CUDA graph (:class:`.graph_step.GraphedStep`;
    on the CPU the same split, eager). With a ``mesh`` the graph holds the
    step's collectives, which needs NCCL: on a card a mesh on gloo raises
    before the first step. Fewer than S steps left run one at a time. The
    display,
    validation and save frequencies round up to multiples of S
    (:func:`call_freqs`), and an event fires after a call in which ``it %
    freq < S``: the first display at ``it <= S``, validation and saves only
    past S, a save at the end, as in the JAX loop.
    """
    check_train_config(cfg)
    dev = mesh.device if mesh is not None else resolve_device(device)
    n_ranks = 1 if mesh is None else mesh.size
    steps_per_call = max(1, int(cfg.train.steps_per_call))
    if cfg.train.batch_size % n_ranks:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} does not divide over "
                         f"{n_ranks} ranks: the global batch is split in equal shards")
    writer = mesh is None or mesh.rank == 0
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
    if mesh is not None:
        broadcast_module_(mesh, state.model)

    step_fn = make_train_step(cfg, mesh)
    # S > 1: each step a replay of a CUDA graph of the step (on the CPU the
    # same prelude and body, eager)
    runner = (GraphedStep(step_fn, state, graph=dev.type == "cuda")
              if steps_per_call > 1 else None)
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
        provider = Provider(train_ds, batch_size=cfg.train.batch_size // n_ranks,
                            num_workers=cfg.train.num_workers, seed=cfg.train.random_seed,
                            rank=0 if mesh is None else mesh.rank)
        batches = device_prefetch(iter(provider.next, None), device=dev)

        def next_batch(step: int) -> dict:
            with span("pea.sample"):
                batch = next(batches)
                return batch if mesh is None else all_gather_batch(mesh, batch)
    logger = ScalarLogger(log_dir or os.path.join(save_path, "log")) if writer else None
    watchdog = LossWatchdog(save_dir=save_path)
    history: list = []
    pending: list = []
    sum_loss = 0.0
    t_start = time.time()
    it = state.step
    display_freq, valid_freq, save_freq = call_freqs(cfg.train)

    def hit(freq: int) -> bool:  # the JAX loop's rule, for S-strided counts too
        return it % freq < steps_per_call

    opt, group = state.optimizer, state.optimizer.param_groups[0]

    def drain():
        nonlocal sum_loss
        if not pending:
            return
        vals = torch.stack(pending).cpu().tolist()
        for j, v in enumerate(vals):
            watchdog.check(v, state=None, step=it - len(vals) + 1 + j)
            sum_loss += v
        if timing is not None:
            timing.setdefault("loss", []).extend(vals)
        pending.clear()

    try:
        while it < total_iters:
            # a call: S steps, or single steps in the tail, as the JAX loop's
            for _ in range(steps_per_call if total_iters - it >= steps_per_call else 1):
                t0 = time.perf_counter()
                batch = next_batch(it)
                t1 = time.perf_counter()
                lr = opt.lr(group)
                _, metrics = (step_fn(state, batch) if runner is None else runner(batch))
                it += 1
                pending.append(metrics["loss"])
                if timing is not None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    timing.setdefault("data_s", []).append(t1 - t0)
                    timing.setdefault("step_s", []).append(time.perf_counter() - t1)
                    timing.setdefault("lr", []).append(lr)

            if hit(display_freq) or it <= steps_per_call:
                drain()
                dt = time.time() - t_start
                avg = sum_loss / (display_freq if it > steps_per_call else max(it, 1))
                if writer:
                    log.info("step %d, loss=%.6f (%.2f s)", it, avg, dt)
                    logger.add(it, loss=avg, lr=lr, sec_per_iter=dt / max(it, 1))
                sum_loss = 0.0
            if (cfg.train.if_valid and _has_valid(valid_ds) and hit(valid_freq)
                    and it > steps_per_call):
                drain()
                if writer:
                    t0 = time.perf_counter()
                    m = validate(it)
                    if timing is not None:
                        timing.setdefault("valid_s", []).append(time.perf_counter() - t0)
                    log.info("valid @%d: %s", it, m)
                    logger.add(it, **m)
                    history.append({"step": it, **m})
                if mesh is not None:
                    barrier(mesh)
            if (hit(save_freq) and it > steps_per_call) or it >= total_iters:
                drain()
                if writer:
                    save_checkpoint(save_path, state, it)
                if mesh is not None:
                    barrier(mesh)
        drain()
        if timing is not None and runner is not None and runner.capture_s is not None:
            timing["capture_s"] = runner.capture_s
    finally:
        if provider is not None:
            provider.close()
        if logger is not None:
            logger.close()
    return state, history
