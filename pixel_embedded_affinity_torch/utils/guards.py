"""Failure detection: a finite-loss watchdog.

The train loop checks every step's loss; on NaN or Inf the watchdog saves
the last good state (when it has one and a directory) and raises with the
step, so a long unattended run fails loudly and can be resumed.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("pea")


class NonFiniteLossError(RuntimeError):
    pass


class LossWatchdog:
    """Tracks recent losses; raises (after saving state) on NaN/Inf.
    ``state`` is a :class:`..train.train_step.TrainState`."""

    def __init__(self, save_dir: str | None = None, patience: int = 0):
        self.save_dir = save_dir
        self.patience = patience
        self._bad = 0
        self.last_good_state = None

    def check(self, loss: float, state=None, step: int = 0):
        if np.isfinite(loss):
            self._bad = 0
            self.last_good_state = state
            return
        self._bad += 1
        if self._bad > self.patience:
            if self.save_dir and self.last_good_state is not None:
                from ..train.checkpoint import save_checkpoint

                path = save_checkpoint(self.save_dir, self.last_good_state, step)
                log.error("non-finite loss at step %d; last good state "
                          "saved to %s", step, path)
            raise NonFiniteLossError(f"loss became non-finite ({loss}) at step {step}")
