"""Seeding (the reference's utils/utils.py:40-46; the JAX package's
``utils/seed.py``): Python's, numpy's and torch's generators, the CUDA
ones included. A seed of None or below 0 seeds nothing."""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int | None):
    if seed is None or seed < 0:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # seeds every CUDA device's generator too
