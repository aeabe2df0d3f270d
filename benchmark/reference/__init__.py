"""The benchmark's plain reference: plain PyTorch, float32, TF32 off.

It imports nothing of the program under test (``pixel_embedded_affinity_torch``)
and nothing of JAX. Each model lives in ``<arch>.py``, found by the arch name
of a configuration; ``ops`` holds the affinities, targets, losses and un-flips,
``amsgrad`` the optimizer, ``steps`` the training losses and ``tiled`` the
tiled engine's blend and stitch. :func:`precision` switches TF32 off for the
reference, or on for the control.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def model_module(arch: str):
    """The reference module of ``arch`` (``benchmark/reference/<arch>.py``)."""
    return importlib.import_module(f"{__name__}.{arch}")


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convolutions and matmuls with TF32 off (the reference) or on
    (the control: the nearest precision below float32), restored after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
