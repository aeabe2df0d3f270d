"""The EMA view's flip rules and their inverse, and the ImageNet constants.

A rule is 3 bits per sample: x-flip, y-flip, xy-transpose, applied in that
order by :func:`..data.device_aug.flip_2d`. ``convert_consistency_flip``
undoes them on the teacher's embedding: transpose, then y-flip, then
x-flip, each where the sample's bit is set (branch-free, so per-sample
rules stay on the device). Tensors are (B, H, W, C), as in the JAX
package, and H == W for the transpose; the port's NCHW model output goes
in as its ``permute(0, 2, 3, 1)`` view.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)
_STATS: dict = {}


def imagenet_stats(device, dtype=torch.float32) -> tuple:
    """(mean, std) as tensors on ``device``, made once: a copy from pageable
    host memory would wait for the queued kernels at every use."""
    key = (torch.device(device), dtype)
    if key not in _STATS:
        _STATS[key] = tuple(torch.as_tensor(a, dtype=dtype, device=key[0])
                            for a in (IMAGENET_MEAN, IMAGENET_STD))
    return _STATS[key]


def _bit(rules_b3: torch.Tensor, i: int) -> torch.Tensor:
    return rules_b3[:, i].bool()[:, None, None, None]


def convert_consistency_flip(emb_bhwc: torch.Tensor, rules_b3: torch.Tensor) -> torch.Tensor:
    """Un-flip per-sample EMA embeddings (B, H, W, C); rules (B, 3). The
    result has the input's strides: ``torch.where`` takes the layout of its
    first operand, so the untransposed one goes first and the affinity
    kernels read the teacher as they read the student."""
    e = torch.where(~_bit(rules_b3, 2), emb_bhwc, emb_bhwc.transpose(1, 2))
    e = torch.where(_bit(rules_b3, 1), e.flip(1), e)
    return torch.where(_bit(rules_b3, 0), e.flip(2), e)
