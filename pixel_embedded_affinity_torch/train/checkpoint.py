"""Training checkpoints: model, optimizer moments and step, for an exact resume.

``<path>/model-%06d.ckpt`` holds ``torch.save`` of ``{"model": state dict
(parameters and BatchNorm buffers), "optimizer": AMSGrad state dict,
"step": int}``. The JAX package's msgpack train checkpoints are not read
here yet; ``convert.train_state_from_flax`` carries a JAX train state held
in memory across.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state, step: int) -> str:
    """Write ``state`` (a TrainState) to <path>/model-%06d.ckpt; returns the file."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"model-{step:06d}.ckpt")
    tmp = fname + ".tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(step)}, tmp)
    os.replace(tmp, fname)
    return fname


def load_checkpoint(fname: str) -> dict:
    return torch.load(fname, map_location="cpu", weights_only=True)


def restore(state, ck: dict):
    """Load a checkpoint dict into ``state`` in place."""
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return state


def latest_checkpoint(path: str) -> str | None:
    if not os.path.isdir(path):
        return None
    cks = sorted(f for f in os.listdir(path) if f.endswith(".ckpt"))
    return os.path.join(path, cks[-1]) if cks else None
