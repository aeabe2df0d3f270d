"""Config: the fields and the ``cvppp`` preset the serving and training
paths read.

Field names and defaults are those of the JAX package's
``config/config.py``, so dotted overrides (``data.data_folder=...``) mean
the same in both packages. Options whose code is not ported yet are kept
with their JAX defaults and raise where they would take effect
(``train.loop.check_train_config``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    arch: str = "resunet2d_deep"
    input_nc: int = 3
    output_nc: int = 2
    emd: int = 16
    filters: tuple = (16, 32, 64, 128, 256)
    # "auto" resolves to float32 (resolve_compute_dtype); bf16 serving is
    # not ported yet
    dtype: str = "auto"


@dataclass
class TrainConfig:
    loss_func: str = "WeightedMSELoss"
    affs0_weight: float = 1.0
    deep_weight: int = 1
    self_emb: float = 1.0
    cross_emb: float = 1.0
    # nonzero selects the mask-head loss and the predicted-mask (BBBC)
    # decode, not ported yet
    mask_weight: float = 0.0
    ct_weight: float = 0.0
    # only "fixed" is ported
    lr_mode: str = "fixed"
    base_lr: float = 1e-4
    total_iters: int = 200000
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


@dataclass
class DataConfig:
    data_folder: str = "./data/CVPPP"
    shifts: tuple = (1, 3, 5, 9, 27)
    neighbor: int = 4
    strides: tuple = (5, 5)
    padding: bool = True
    valid_set: str = "local_20_1"
    if_ema_noise: bool = False
    if_ema_blur: bool = False
    if_ema_intensity: bool = True
    if_ema_mask: bool = True
    if_ema_flip: bool = True
    # targets and the EMA view built on the device from the labels and the
    # clean image; the port has no host-side path for either
    device_gt: bool = False
    device_ema: bool = False
    # the whole training set resident on the device: not ported, and True
    # raises (the JAX preset's True is left out of the port's)
    device_resident: bool = False


@dataclass
class Config:
    name: str = "cvppp"
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    save_path: str = "./models"


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
        "data": {"shifts": (1, 3, 5, 9, 27), "strides": (5, 5),
                 "device_gt": True, "device_ema": True},
    },
}


def load_config(preset: str | None = None, overrides: dict | None = None) -> Config:
    cfg = Config()
    if preset is not None:
        if preset not in PRESETS:
            raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
        _apply(cfg, PRESETS[preset])
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


def resolve_compute_dtype(model_cfg: ModelConfig) -> str:
    """"auto" -> "float32"; explicit values pass through."""
    return "float32" if model_cfg.dtype == "auto" else model_cfg.dtype
