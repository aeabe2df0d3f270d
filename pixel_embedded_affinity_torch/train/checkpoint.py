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

:func:`save_checkpoint_dcp` and :func:`load_checkpoint_dcp` are the
counterparts of the JAX package's orbax backend (``save_checkpoint_orbax``,
``load_checkpoint_orbax``, tensorstore's OCDBT format, which the card's
machine lacks): the same tree through ``torch.distributed.checkpoint``
(DCP), PyTorch's multi-rank checkpoint, in ``<path>/dcp-%06d``. Every
rank of a process group calls it, and a tensor that all ranks hold is
written once. Its files do not interchange with JAX's orbax directories;
msgpack stays the format both packages read.
"""

from __future__ import annotations

import logging
import os

import numpy as np
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


_SEP = "/"
# a stateless optax link ({}): DCP flattens dicts and would drop an empty one
_EMPTY = "{}"


def _flat_items(tree: dict, prefix: str = ""):
    """(path "a/b/c", leaf) of a nested dict; an empty dict is a leaf."""
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and v:
            yield from _flat_items(v, key + _SEP)
        else:
            yield key, v


def save_checkpoint_dcp(path: str, state, step: int) -> str:
    """Write ``state`` (a TrainState) to ``<path>/dcp-%06d`` with
    ``torch.distributed.checkpoint``: the tree :func:`save_checkpoint`
    writes (``train_state_to_flax``), one entry a leaf named by its path
    ("params/inconv/conv1/kernel"); arrays of rank >= 1 as tensors, the
    rest (step, optimizer counts) as DCP bytes entries, so they come back
    with their types, and a stateless link ``{}`` as the string "{}".
    Under a process group
    every rank calls it. Returns the directory."""
    import torch.distributed.checkpoint as dcp

    tree = train_state_to_flax(state.model, state.optimizer, step)
    flat = {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) and v.ndim
            else _EMPTY if v == {} else v for k, v in _flat_items(tree)}
    target = os.path.join(os.path.abspath(path), f"dcp-{step:06d}")
    dcp.save(flat, checkpoint_id=target)
    return target


def load_checkpoint_dcp(target: str) -> dict:
    """The tree of a :func:`save_checkpoint_dcp` directory, as
    :func:`load_checkpoint` returns a msgpack file's (numpy leaves), for
    :func:`restore`. Needs no state: the entries and their shapes come from
    the directory's metadata."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = dcp.FileSystemReader(target)
    meta = reader.read_metadata().state_dict_metadata
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            if isinstance(m, TensorStorageMetadata) else None for k, m in meta.items()}
    dcp.load(flat, storage_reader=reader)
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(_SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy() if isinstance(v, torch.Tensor) else {} if v == _EMPTY else v
    return tree
