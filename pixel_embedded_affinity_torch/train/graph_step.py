"""The training step as a CUDA graph: ``train.steps_per_call`` on the card.

The JAX package runs S > 1 steps a dispatch as one ``lax.scan`` of the
step. The card's counterpart is a CUDA graph of the step, replayed once a
step: the whole step (target building, the student and teacher forwards,
the un-flip, the loss kernels, the backward and the optimizer's update) is
issued by one launch, with no host work between its kernels.

A step is split in two. The prelude stays eager: the batch (the device
sampler's, or the host sampler's after its copy to the card) and, with
``device_ema``, the EMA view and its flip rules, whose draws come from a
CUDA generator seeded from (seed, step) that a replay would repeat. It
writes the batch into static input buffers, and the optimizer writes the
update's rate and bias corrections into its scalar tensors
(:meth:`.optim._Chain.load_device_scalars`). The body,
``step.grads(model, batch)`` then ``optimizer.update()``, is what the graph
holds; it branches on no value on the device, and its kernels take their
offsets by value and launch on the current stream, the capture's.

:class:`GraphedStep` runs the first step of a run eagerly, on a side
stream: it is the run's own step (no step is trained twice), and it
settles what a capture cannot do (the lazy AMSGrad state, cuDNN's
algorithm choice, the cached interpolation taps). Its second call
captures the body once, in ``thread_local`` mode (the host sampler's
threads may use the card meanwhile), then replays it; every later call
replays. A capture executes nothing, so the optimizer's counts that it
advanced are put back, and each replay advances them by one update. The
kernel wrappers count the launches they record into the graph, once
(:mod:`..ops.launch_count`); ``per_replay`` holds those counts, and the
replays run the kernels again uncounted. A capture or replay that fails
raises: nothing falls back to the eager step.

A data-parallel step (``step.mesh``, :mod:`..parallel.mesh`) is graphed
the same way. The prelude draws the EMA view of the global batch (and the
host sampler's ranks gather theirs into it, before the call); the body
reads this rank's shard of the static buffers, views as
:func:`..parallel.mesh.shard_batch` gives them, and issues every
collective of the step on the capture's stream: the cross-rank
BatchNorm's all-reduces, the mask head's counts and the flat all-reduce
of the gradients and metrics. Their sizes are fixed by the batch's shape,
and none of them reads a value back to the host, so a replay issues them
again on the same buffers. Only NCCL's collectives can be captured: a
mesh on another backend (gloo) asked to capture raises before any step
(:func:`..parallel.mesh.check_capturable`). The warm-up step's
collectives make NCCL's communicator, which a capture cannot. At world
size 1 the mesh issues no collective, and the graph is the one-process
step's.

On the CPU, where there are no graphs, ``graph=False`` runs the same
prelude, buffers and scalar tensor, and calls the body eagerly, on gloo's
collectives with a mesh.
"""

from __future__ import annotations

import time

import torch

from ..ops.launch_count import launch_counts
from ..parallel.mesh import check_capturable, shard_batch
from ..utils.profiling import span


class GraphedStep:
    """``runner(batch) -> (pred, metrics)``: one training step of ``step``
    (a :class:`.train_step.TrainStep2D` or ``TrainStep3D``, data-parallel
    when it has a mesh) on ``state``, updating it in place as ``step(state, batch)`` does.

    ``graph``: capture the body as a CUDA graph and replay it (the card),
    else run it eagerly (the CPU). ``pred`` is the graph's static output,
    overwritten by the next call; ``metrics`` are copies. ``capture_s`` is
    the capture's seconds, ``per_replay`` each kernel wrapper's launches in
    one replay (by name) and ``replays`` the replays so far, once the
    capture has run."""

    def __init__(self, step, state, graph: bool):
        if graph:
            check_capturable(step.mesh)
        self.step, self.state, self.graph = step, state, graph
        self.static = None
        self.out = None
        self.cuda_graph = None
        self.per_replay: dict = {}
        self.replays = 0
        self.capture_s = None

    def _body(self, batch: dict):
        pred, metrics = self.step.grads(self.state.model, shard_batch(batch, self.step.mesh))
        self.state.optimizer.update()
        return pred, metrics

    def _warm_up(self, batch: dict):
        """The run's first step, eager, on a side stream when on a card."""
        if not self.graph:
            return self._body(batch)
        side = torch.cuda.Stream(batch["image"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self._body(batch)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self, batch: dict):
        """Allocate the static inputs from ``batch``; on a card capture the
        body on them, the optimizer's host counts kept."""
        self.static = {k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()}
        if not self.graph:
            return
        t0 = time.perf_counter()
        opt = self.state.optimizer
        counts = (opt.count, [(st, st["count"]) for st in opt.state.values() if "count" in st])
        before = launch_counts()
        self.cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.cuda_graph, capture_error_mode="thread_local"):
            self.out = self._body(self.static)
        self.per_replay = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                           if n != before.get(k, 0)}
        opt.count = counts[0]
        for st, n in counts[1]:
            st["count"] = n
        self.capture_s = time.perf_counter() - t0

    def __call__(self, batch: dict):
        with span("pea.step"):
            if self.step.device_ema:
                with span("pea.ema_view"):
                    batch = self.step.ema_batch(batch, self.state.step)
            opt = self.state.optimizer
            opt.load_device_scalars()
            if self.out is None:  # the run's first step
                self.out = self._warm_up(batch)
                self.state.step += 1
                return self.out
            if self.static is None:
                self._capture(batch)
            for k, v in self.static.items():
                if torch.is_tensor(v):
                    v.copy_(batch[k])
            if self.cuda_graph is None:
                self.out = self._body(self.static)
            else:
                self.cuda_graph.replay()
                self.replays += 1
                opt.advance_host_counts()
            self.state.step += 1
            pred, metrics = self.out
            return pred, {k: v.clone() for k, v in metrics.items()}
