"""Host input pipeline: threaded sample workers, batching, device copy.

Worker threads call ``dataset.sample(rng)`` into a bounded queue (sample
building is numpy and releases the GIL), ``Provider.next()`` stacks a
batch, and :func:`to_device` copies it to the card from pinned memory with
``non_blocking=True``, so the host goes on while the copy is queued behind
the step in flight.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into batched arrays."""
    return {key: np.stack([s[key] for s in samples], axis=0) for key in samples[0]}


class ThreadedSampler:
    """Workers repeatedly call dataset.sample(rng) into a bounded queue."""

    def __init__(self, dataset, num_workers: int = 2, queue_size: int = 8,
                 seed: int = 0):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.threads = []
        for i in range(num_workers):
            rng = np.random.default_rng(seed * 1000 + i)
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
                 seed: int = 0):
        self.batch_size = batch_size
        self.sampler = ThreadedSampler(dataset, num_workers=num_workers, seed=seed)

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
