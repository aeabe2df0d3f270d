"""Training checkpoints in the JAX package's format, for an exact resume in
either package.

``<path>/model-%06d.ckpt`` holds Flax's msgpack of the JAX ``TrainState``
(:func:`..convert.train_state_to_flax`): ``params`` and ``batch_stats``
under the Flax names, ``opt_state`` as the JAX ``make_optimizer``'s chain
lays it out, and ``step``. The JAX package's ``load_checkpoint`` and
``from_state_dict`` read the port's files, and :func:`load_checkpoint`
reads the JAX package's. It also reads the ``torch.save`` files that
earlier port runs wrote (``{"model", "optimizer", "step"}``, a zip
archive); nothing writes that form any more.
"""

from __future__ import annotations

import logging
import os

import torch

from ..checkpoint import load_jax_checkpoint, write_jax_checkpoint
from ..convert import load_flax_variables, opt_state_from_flax, train_state_to_flax

log = logging.getLogger("pea")
_ZIP_MAGIC = b"PK"


def save_checkpoint(path: str, state, step: int) -> str:
    """Write ``state`` (a TrainState) to <path>/model-%06d.ckpt; returns the file."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"model-{step:06d}.ckpt")
    tmp = fname + ".tmp"
    write_jax_checkpoint(tmp, train_state_to_flax(state.model, state.optimizer, step))
    os.replace(tmp, fname)
    return fname


def load_checkpoint(fname: str) -> dict:
    """The checkpoint's tree: Flax's ``{params, batch_stats, opt_state,
    step}``, or an earlier port run's ``{model, optimizer, step}``."""
    with open(fname, "rb") as f:
        magic = f.read(2)
    if magic == _ZIP_MAGIC:
        return torch.load(fname, map_location="cpu", weights_only=True)
    return load_jax_checkpoint(fname)


def restore(state, ck: dict):
    """Load a checkpoint's tree into ``state`` in place, by the JAX loop's
    resume rule: parameters, statistics and step always; the optimizer's
    state only where its tree fits the configured chain, else a logged
    warning and the fresh optimizer state."""
    if "model" in ck:  # an earlier port run's torch.save
        state.model.load_state_dict(ck["model"])
        opt = ck["optimizer"]
        fits = (type(state.optimizer).__name__ == "AMSGrad"
                and state.optimizer.schedule is None
                and all(set(st) == {"count", "mu", "nu", "nu_max"}
                        for st in opt["state"].values()))
        if fits:
            state.optimizer.load_state_dict(opt)
            state.optimizer.count = next((st["count"] for st in opt["state"].values()), 0)
        else:
            log.warning("checkpoint opt_state incompatible (an AMSGrad state at a fixed "
                        "rate); falling back to fresh optimizer state")
        state.step = int(ck["step"])
        return state
    load_flax_variables(state.model, ck)
    if "opt_state" in ck:
        try:
            opt_state_from_flax(ck["opt_state"], state.model, state.optimizer)
        except ValueError as e:
            log.warning("checkpoint opt_state incompatible (%s); falling back to fresh "
                        "optimizer state", e)
    state.step = int(ck["step"])
    return state


def latest_checkpoint(path: str) -> str | None:
    if not os.path.isdir(path):
        return None
    cks = sorted(f for f in os.listdir(path) if f.endswith(".ckpt"))
    return os.path.join(path, cks[-1]) if cks else None
