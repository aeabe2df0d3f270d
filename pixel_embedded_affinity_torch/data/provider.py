"""Host input pipeline: threaded sample workers, batching, device copy.

Worker threads call ``dataset.sample(rng)`` into a bounded queue (sample
building is numpy and releases the GIL), ``Provider.next()`` stacks a
batch, and :func:`device_prefetch` keeps the next batches' copies to the
card in flight on a side stream while the step runs (:func:`to_device`
copies one batch on the current stream).
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into batched arrays."""
    return {key: np.stack([s[key] for s in samples], axis=0) for key in samples[0]}


class ThreadedSampler:
    """Workers repeatedly call dataset.sample(rng) into a bounded queue.
    Worker i draws from ``seed * 1000 + i``; on data-parallel rank r > 0
    from (``seed * 1000 + i``, r), so each rank draws its own samples."""

    def __init__(self, dataset, num_workers: int = 2, queue_size: int = 8,
                 seed: int = 0, rank: int = 0):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.threads = []
        for i in range(num_workers):
            rng = np.random.default_rng(seed * 1000 + i if rank == 0
                                        else [seed * 1000 + i, rank])
            t = threading.Thread(target=self._worker, args=(rng,), daemon=True)
            t.start()
            self.threads.append(t)

    def _worker(self, rng):
        while not self._stop.is_set():
            try:
                s = self.dataset.sample(rng)
            except Exception as e:  # surface worker failures to the consumer
                self.q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self.q.put(s, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def get(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=5)


class Provider:
    """Infinite batch provider: next() -> batched numpy dict."""

    def __init__(self, dataset, batch_size: int = 2, num_workers: int = 2,
                 seed: int = 0, rank: int = 0):
        self.batch_size = batch_size
        self.sampler = ThreadedSampler(dataset, num_workers=num_workers, seed=seed, rank=rank)

    def next(self) -> dict:
        return collate([self.sampler.get() for _ in range(self.batch_size)])

    def close(self):
        self.sampler.close()


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; to a card through pinned
    memory and a non-blocking copy."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def device_prefetch(batches, sharding=None, depth: int = 2, device=None):
    """Double-buffered host -> device transfer: yields the numpy batches of
    ``batches`` as tensors on the device, in order, while the copies of the
    next ``depth`` are in flight, as the JAX package's does. On a card each batch is copied from
    pinned memory with ``non_blocking=True`` on a side stream; the consuming
    stream waits on the copy's event, and ``record_stream`` keeps the
    tensors' memory from being reused while it may still read them. With a
    ``sharding`` (:mod:`..parallel.mesh`) only this rank's part of each
    array is copied, to the mesh's device; else to ``device`` (CUDA unless
    "cpu" is asked for). On the CPU the tensors share the arrays' memory,
    as :func:`to_device` gives them."""
    from ..device import resolve_device

    dev = sharding.mesh.device if sharding is not None else resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(batch):
        if sharding is not None:
            batch = {k: sharding.local(v) for k, v in batch.items()}
        if stream is None:
            return to_device(batch, dev), None
        with torch.cuda.stream(stream):
            out = to_device(batch, dev)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    it = iter(batches)
    buf: collections.deque = collections.deque()
    for b in it:
        buf.append(put(b))
        if len(buf) == depth:
            break
    while buf:
        out, event = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        if event is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        yield out
