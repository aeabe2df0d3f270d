"""Config: the fields and the presets the serving and training paths read:
``cvppp`` and ``bbbc039v1`` (2D serving and training), ``cvppp_resnet50``
and ``cvppp_resnet101`` (the ResNet embedding nets on CVPPP, trained with
the discriminative term) and ``ac3ac4`` (3D serving and training), with
YAML overlays.

Field names and defaults are those of the JAX package's
``config/config.py``, so dotted overrides (``data.data_folder=...``) mean
the same in both packages. The port has the fields its code reads, and
those that the JAX package declares and the port does not read
(``model.merge_mode``, ``model.s2d_train``, ``cache_path``), so that its
YAML files load. :func:`load_config` applies the preset, then a YAML
file (``yaml.safe_load``), then the overrides, as the JAX package's does.
Values whose code is not ported raise where they would take effect
(``train.loop.check_train_config``). ``model.dtype`` and
``model.bf16_tiled_infer`` are served; their defaults give float32 compute
in the port (see their comments).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    # resunet2d_deep | resnet50_embedding | resnet101_embedding (2D),
    # unet_pni_deep | unet3d_mala (3D; MALA is built, not trained or
    # served tiled, as in the JAX package)
    arch: str = "resunet2d_deep"
    input_nc: int = 3
    output_nc: int = 2
    emd: int = 16
    filters: tuple = (16, 32, 64, 128, 256)
    # the compute dtype of training and serving: "float32", "bfloat16", or
    # "auto", which resolves to float32 here (resolve_compute_dtype; the
    # JAX package resolves it to bfloat16 on its TPU). With "bfloat16" the
    # models compute as Flax's dtype rule has it: every conv's input,
    # weight and bias cast to bfloat16, BatchNorm's statistics in float32,
    # the outputs in bfloat16; parameters, gradients, optimizer state,
    # running statistics and checkpoints stay float32, so a checkpoint
    # serves in either dtype
    dtype: str = "auto"
    # the tiled 3D predictor in bfloat16, the embedding cast to float32
    # before the affinity, as the JAX package's serving does; the predictor
    # is bfloat16 when this is True or the dtype resolves to bfloat16, so
    # False with "auto" serves float32 (the JAX package's "auto" is
    # bfloat16 on its TPU, where False alone does not give float32). Off by
    # default in the port (the JAX package's default is on)
    bf16_tiled_infer: bool = False
    # the tiled 3D predictor of unet_pni_deep as the folded-BatchNorm
    # z-concat 2D-conv graph (models/fast_forward3d.py), exact math; False
    # serves the dense module. Off by default in the port (the JAX
    # package's default is on): on the H100 the dense module is faster
    # (PERF.md, Findings)
    fast_tiled_infer: bool = False
    # declared by the JAX package, where it trains resunet2d_deep through a
    # space-to-depth twin of the same function (a TPU lane-padding rewrite);
    # the port trains the direct model whatever it says
    s2d_train: bool = True
    # int8 serving of resunet2d_deep through the fast forward (run_inference_2d
    # with use_fast): INT8_DEFAULT_SITES in int8, the activation scales
    # calibrated once on the first int8_calib_k images (max|x|, or the
    # int8_calib_pct quantile of |x|, e.g. 0.999); without use_fast it
    # changes nothing, as in the JAX package
    int8_infer: bool = False
    int8_calib_k: int = 8
    int8_calib_pct: float | None = None
    # declared by the JAX package and read by neither package
    merge_mode: str = "add"


@dataclass
class TrainConfig:
    loss_func: str = "WeightedMSELoss"
    # "affinity" (the embedding->affinity losses only) or "discriminative",
    # which adds disc_weight x the pull/push/reg discriminative loss of the
    # full-scale embedding to the 2D step (the ResNet presets' recipe)
    loss_mode: str = "affinity"
    disc_weight: float = 1.0
    affs0_weight: float = 1.0
    deep_weight: int = 1
    self_emb: float = 1.0
    cross_emb: float = 1.0
    # nonzero adds the mask-head loss to the 2D step and seeds the decode
    # with the predicted foreground mask (BBBC)
    mask_weight: float = 0.0
    ct_weight: float = 0.0
    # 3D: the full-scale loss, norm5 (the shift table) at 5, norm1 (unit
    # shifts) at any other value
    embedding_mode: int = 5
    # "adam" (AMSGrad, as the reference's Adam(amsgrad=True)) or "sgd"
    # (momentum 0.9, weight decay 1e-4), as the JAX make_optimizer builds
    opt_type: str = "adam"
    # the schedule of the learning rate (train/optim.py::make_schedule):
    # "fixed" (and "cosine", which the reference runs at base_lr), "poly"
    # (warmup_iters, decay_iters, power, end_lr), "steplr",
    # "multi_steplr", "explr", "lambdalr"
    lr_mode: str = "fixed"
    base_lr: float = 1e-4
    end_lr: float = 1e-4
    total_iters: int = 200000
    warmup_iters: int = 0
    decay_iters: int = 100000
    power: float = 1.5
    weight_decay: float = 1e-6
    batch_size: int = 2
    num_workers: int = 2
    display_freq: int = 100
    valid_freq: int = 1000
    save_freq: int = 1000
    random_seed: int = 555
    resume: bool = False
    if_valid: bool = True
    # the affinity kernels on (False: the plain path, differentiated by
    # autograd), and the WeightedMSE criterion folded into them
    use_pallas: bool = True
    fuse_loss: bool = True
    # 3D: the decoders of the in-loop validation ("waterz", "mutex", "lmc")
    valid_decoders: tuple = ("waterz",)
    # > 1: each step a replay of a CUDA graph of the step, S steps a call
    # (train/graph_step.py); display, valid and save frequencies round up
    # to multiples of S, as in the JAX loop, which scans S steps in one jit
    steps_per_call: int = 1


@dataclass
class DataConfig:
    # "cvppp", "bbbc039v1" or "ac3ac4"
    dataset: str = "cvppp"
    data_folder: str = "./data/CVPPP"
    # the side of the square training crop (the 2D device samplers')
    size: int = 544
    shifts: tuple = (1, 3, 5, 9, 27)
    neighbor: int = 4
    strides: tuple = (5, 5)
    padding: bool = True
    # the 2D host targets: one class-balancing weight map per offset
    separate_weight: bool = True
    valid_set: str = "local_20_1"
    if_ema_noise: bool = False
    if_ema_blur: bool = False
    if_ema_intensity: bool = True
    if_ema_mask: bool = True
    if_ema_flip: bool = True
    # targets and the EMA view built on the device from the labels and the
    # clean image; False: the host samplers build them (data/cvppp.py,
    # bbbc.py, ac3ac4.py) and the step takes them from the batch
    device_gt: bool = False
    device_ema: bool = False
    # the whole training set resident on the device, sampled and augmented
    # there (data/device_data.py: the cvppp, bbbc039v1 and ac3ac4
    # samplers), on in the three presets as in JAX; False trains from the
    # host samplers, on data_folder's files or on train()'s data_override
    device_resident: bool = False
    # bbbc039v1: the reflect padding around the images before the random
    # crop
    bbbc_padding: int = 30
    # 3D (AC3/AC4): the volume served and trained on ("ac4"; the CLI's
    # -m test serves "ac3"), the training slices (the first train_split),
    # the tile the tiled engine runs the model on and the training crop,
    # and the margin around the crop that the sampler's warps read
    dataset_name: str = "ac4"
    train_split: int = 80
    crop_size: tuple = (18, 160, 160)
    padding_3d: int = 50


@dataclass
class Config:
    name: str = "cvppp"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    save_path: str = "./models"
    # declared by the JAX package and read by neither package
    cache_path: str = "./caches"


def _apply(dc, overrides: dict):
    for k, v in overrides.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {type(dc).__name__}.{k}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(dc, k, v)


PRESETS: dict[str, dict[str, Any]] = {
    # the JAX package's cvppp preset (scripts_cvppp/config/cvppp.yaml)
    "cvppp": {
        "name": "cvppp",
        "model": {"arch": "resunet2d_deep", "input_nc": 3, "output_nc": 2,
                  "filters": (16, 32, 64, 128, 256)},
        "train": {"mask_weight": 0.0, "ct_weight": 0.0, "lr_mode": "fixed",
                  "base_lr": 1e-4, "batch_size": 2},
        "data": {"dataset": "cvppp", "size": 544,
                 "shifts": (1, 3, 5, 9, 27), "strides": (5, 5),
                 "device_gt": True, "device_ema": True,
                 "device_resident": True},
    },
    # the JAX package's bbbc039v1 preset
    # (scripts_bbbc039v1/config/bbbc039v1.yaml)
    "bbbc039v1": {
        "name": "bbbc039v1",
        "model": {"arch": "resunet2d_deep", "input_nc": 3, "output_nc": 2,
                  "filters": (16, 32, 64, 128, 256)},
        "train": {"mask_weight": 1000.0, "lr_mode": "fixed",
                  "base_lr": 1e-4, "batch_size": 2},
        "data": {"dataset": "bbbc039v1", "size": 256,
                 "shifts": (1, 3, 5, 9, 11), "strides": (10, 10),
                 "device_gt": True, "device_ema": True,
                 "device_resident": True},
    },
    # the JAX package's ResNet-50/101 presets (BASELINE configs 3 and 4):
    # CVPPP training with the discriminative and affinity losses
    "cvppp_resnet50": {
        "name": "cvppp_resnet50",
        "model": {"arch": "resnet50_embedding", "input_nc": 3, "output_nc": 2},
        "train": {"loss_mode": "discriminative", "disc_weight": 1.0,
                  "lr_mode": "fixed", "base_lr": 1e-4, "batch_size": 2},
        "data": {"dataset": "cvppp", "size": 544,
                 "shifts": (1, 3, 5, 9, 27), "strides": (5, 5),
                 "device_gt": True, "device_ema": True,
                 "device_resident": True},
    },
    "cvppp_resnet101": {
        "name": "cvppp_resnet101",
        "model": {"arch": "resnet101_embedding", "input_nc": 3, "output_nc": 2},
        "train": {"loss_mode": "discriminative", "disc_weight": 1.0,
                  "lr_mode": "fixed", "base_lr": 1e-4, "batch_size": 2},
        "data": {"dataset": "cvppp", "size": 544,
                 "shifts": (1, 3, 5, 9, 27), "strides": (5, 5),
                 "device_gt": True, "device_ema": True,
                 "device_resident": True},
    },
    # the JAX package's ac3ac4 preset (scripts_ac3ac4/config/ac3ac4.yaml),
    # the fields the port reads
    "ac3ac4": {
        "name": "ac3ac4",
        "model": {"arch": "unet_pni_deep", "input_nc": 1, "output_nc": 12,
                  "filters": (28, 36, 48, 64, 80)},
        "train": {"embedding_mode": 5, "lr_mode": "fixed", "base_lr": 1e-4,
                  "batch_size": 2, "valid_decoders": ("waterz",)},
        "data": {"dataset": "ac3ac4", "dataset_name": "ac4",
                 "train_split": 80, "crop_size": (18, 160, 160),
                 "padding_3d": 50, "device_gt": True, "device_ema": True,
                 "device_resident": True},
    },
}


def load_config(preset: str | None = None, overrides: dict | None = None,
                yaml_path: str | None = None) -> Config:
    """The preset, then the YAML file's keys, then ``overrides``; an
    unknown key raises KeyError."""
    cfg = Config()
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        _apply(cfg, PRESETS[preset])
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            _apply(cfg, yaml.safe_load(f))
    if overrides:
        _apply(cfg, overrides)
    return cfg


def parse_overrides(pairs) -> dict:
    """``["data.data_folder=/data/CVPPP", ...]`` -> nested dict; values are Python literals
    where they parse as one, else strings."""
    import ast

    out: dict = {}
    for p in pairs or []:
        key, val = p.split("=", 1)
        cur = out
        parts = key.split(".")
        for k in parts[:-1]:
            cur = cur.setdefault(k, {})
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        cur[parts[-1]] = val
    return out


COMPUTE_DTYPES = ("float32", "bfloat16")


def resolve_compute_dtype(model_cfg: ModelConfig) -> str:
    """"auto" -> "float32"; "float32" and "bfloat16" pass through; any other
    value raises ValueError."""
    d = model_cfg.dtype
    if d == "auto":
        return "float32"
    if d not in COMPUTE_DTYPES:
        raise ValueError(f"model.dtype={d!r}: expected 'auto' or one of {COMPUTE_DTYPES}")
    return d
