"""Multi-process helpers for the data-parallel training path.

The port of the JAX package's ``parallel/multihost.py``. There,
``train.py --distributed`` calls ``jax.distributed.initialize()`` and the
data mesh spans every process's devices. Here one process drives one card:
``torchrun --nproc_per_node=N -m pixel_embedded_affinity_torch.train ...
--distributed`` starts N of them, :func:`initialize` joins them into one
process group, and each rank takes its part of every host array
(:func:`to_global`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, Sharding, get_mesh


def initialize(device="cuda", backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None) -> Mesh:
    """Join the process group and return this rank's :class:`Mesh`.

    ``rank``, ``world_size`` and the local rank come from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method``
    None reads ``MASTER_ADDR`` and ``MASTER_PORT``) unless given. On the
    card the backend is NCCL on ``cuda:LOCAL_RANK``; with ``device="cpu"``
    it is gloo on the CPU; without a card, a CUDA device raises. ``backend``
    overrides the choice (gloo on CUDA tensors: two ranks on one card). A
    process group that is already initialised is joined as it is."""
    dev = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw["init_method"] = init_method
        if rank is not None:
            kw["rank"] = rank
        if world_size is not None:
            kw["world_size"] = world_size
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), **kw)
    return get_mesh(dev)


def to_global(x, sharding: Sharding) -> torch.Tensor:
    """A host array of the FULL global shape, the same on every rank ->
    this rank's part of it on its device: all of it under a replicated
    sharding, its slice of the leading axis under a batch sharding."""
    part = sharding.local(x)
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(sharding.mesh.device)


def global_batch(batch: dict, sharding: Sharding) -> dict:
    """Apply :func:`to_global` over a batch dict."""
    return {k: to_global(v, sharding) for k, v in batch.items()}


def is_multiprocess() -> bool:
    """A process group with more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
