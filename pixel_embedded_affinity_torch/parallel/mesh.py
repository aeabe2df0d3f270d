"""Data parallelism over ``torch.distributed``: the mesh, its shardings and
the collectives the port runs on it.

The port of the JAX package's ``parallel/mesh.py``. JAX builds one 'data'
mesh over many devices of one process, shards the batch over it and lets
XLA insert the collectives. PyTorch runs one process per card: a
:class:`Mesh` is this process's place in the process group (its rank, the
world size and its device), a sharding says which part of a host array
this rank holds, and the collectives are explicit.

Every collective here is an ``all_reduce`` or a ``broadcast``: gloo takes
CUDA tensors for those two only, and two ranks sharing one card (which
NCCL refuses) run on gloo. An all-gather is an all-reduce of a
zero-filled buffer into which each rank writes its own slice, which is
exact. At world size 1 the collectives are not called.

The collectives of a training step take no value back to the host and
allocate their buffers on the current stream, so on NCCL a CUDA graph of
the step holds them (:mod:`..train.graph_step`); gloo's cannot be
captured (:func:`check_capturable`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D 'data' mesh: ``group`` (None: no
    process group, one process), ``rank``, ``size`` (the world size) and
    ``device``, this rank's card or the CPU."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    def __deepcopy__(self, memo):
        return self  # a handle on the process group: copies of a model share it


def get_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """The mesh of the default process group, or of this process alone when
    none is initialised. ``devices``: this rank's device (a device, a
    string, or a one-element list of either); None: ``cuda:LOCAL_RANK``
    (:func:`.multihost.initialize` sets it), which raises without a card."""
    from ..device import resolve_device

    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError(f"one device a process, got {len(devices)}")
        devices = devices[0]
    if devices is None:
        import os

        devices = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(devices)
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, axis_name)
    return Mesh(None, 0, 1, dev, axis_name)


@dataclass(frozen=True)
class Sharding:
    """How a host array of the full global shape lies on ``mesh``: with
    ``split`` its leading axis is cut in ``mesh.size`` equal contiguous
    parts, rank r holding part r; without, every rank holds all of it."""

    mesh: Mesh
    split: bool

    def local(self, x):
        """This rank's part of ``x`` (numpy or a tensor): a view."""
        if not self.split or self.mesh.size == 1:
            return x
        n, size = x.shape[0], self.mesh.size
        if n % size:
            raise ValueError(f"a leading axis of {n} does not split over {size} ranks")
        k = n // size
        return x[self.mesh.rank * k:(self.mesh.rank + 1) * k]


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """Shard the leading (batch) axis across the mesh."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Every rank holds the whole array."""
    return Sharding(mesh, False)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's part of every tensor of a global batch (views)."""
    if mesh is None or mesh.size == 1:
        return batch
    sharding = batch_sharding(mesh, mesh.axis_name)
    return {k: sharding.local(v) for k, v in batch.items()}


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_mean_(mesh: Mesh, tensors: list) -> None:
    """Replace each tensor by its mean over the ranks, in place, through one
    all-reduce of one flat buffer per dtype."""
    if mesh.size == 1 or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce_sum_(mesh, flat).div_(mesh.size)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_gather_batch(mesh: Mesh, batch: dict) -> dict:
    """The global batch from each rank's part (concatenated in rank order),
    on every rank: each tensor an all-reduce of a zero-filled buffer holding
    this rank's part at its place, which adds only zeros to any value."""
    if mesh.size == 1:
        return batch
    out = {}
    for k, t in batch.items():
        n = t.shape[0]
        buf = torch.zeros((n * mesh.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        buf[mesh.rank * n:(mesh.rank + 1) * n] = t
        out[k] = all_reduce_sum_(mesh, buf)
    return out


def broadcast_module_(mesh: Mesh, module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank, in place: one
    broadcast of one flat buffer per dtype. Runs whenever there is a process
    group, at world size 1 too, where it leaves every bit as it was."""
    if mesh.group is None:
        return
    by_dtype: dict = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=mesh.group)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))


def check_capturable(mesh: Mesh | None) -> None:
    """Raise unless a CUDA graph can hold ``mesh``'s collectives: a mesh
    with a process group must be on NCCL, the one backend whose
    collectives CUDA graphs capture. Gloo runs its collectives on the host,
    and a graph would replay none of them."""
    if mesh is None or mesh.group is None:
        return
    backend = dist.get_backend(mesh.group)
    if backend != "nccl":
        raise RuntimeError(
            f"train.steps_per_call > 1 on a card captures the data-parallel step, "
            f"collectives included, in a CUDA graph; only NCCL's collectives can be "
            f"captured, and this process group runs on {backend}: join it on NCCL "
            f"(--distributed on cuda), or train with train.steps_per_call=1")


def barrier(mesh: Mesh) -> None:
    """Wait for every rank: an all-reduce of one value on this rank's
    device (NCCL's and gloo's alike), when there is a process group."""
    if mesh.group is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def split_positions(n: int, mesh: Mesh | None) -> slice:
    """This rank's contiguous part of a list of ``n`` items cut in parts of
    ceil(n / size): the last ranks get fewer, or none, when n is short."""
    if mesh is None or mesh.size == 1:
        return slice(0, n)
    k = -(-n // mesh.size)
    return slice(min(n, mesh.rank * k), min(n, (mesh.rank + 1) * k))

