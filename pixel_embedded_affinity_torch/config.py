"""Config: the fields and the ``cvppp`` preset the serving path reads.

Field names and defaults are those of the JAX package's
``config/config.py``, so dotted overrides (``data.data_folder=...``) mean
the same in both packages.
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
    # nonzero selects the predicted-mask (BBBC) decode, not ported yet
    mask_weight: float = 0.0


@dataclass
class DataConfig:
    data_folder: str = "./data/CVPPP"
    shifts: tuple = (1, 3, 5, 9, 27)
    neighbor: int = 4
    strides: tuple = (5, 5)
    padding: bool = True
    valid_set: str = "local_20_1"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


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
    "cvppp": {
        "model": {"arch": "resunet2d_deep", "input_nc": 3, "output_nc": 2,
                  "filters": (16, 32, 64, 128, 256)},
        "train": {"mask_weight": 0.0},
        "data": {"shifts": (1, 3, 5, 9, 27), "strides": (5, 5)},
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
