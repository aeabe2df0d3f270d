"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fall-back to the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def float32_convs():
    """cuDNN convolutions in full float32 inside the block: TF32, which
    PyTorch allows by default, is switched off and restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic convolution algorithms inside the block
    (``torch.backends.cudnn.deterministic``), restored after."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev
