"""MALA valid-convolution 3D UNet (NCDHW), the port of the JAX package's
``models/unet3d_mala.py``.

Valid (unpadded) 3x3x3 convs with LeakyReLU(0.005), (1, 3, 3) max-pools,
depthwise (1, 3, 3) transposed-conv upsampling (kernel = stride, no bias)
followed by a 1x1x1 conv, center-crop-and-concat skips, and a 1x1x1 head to
``emd`` channels: (B, 1, 53, 268, 268) in, (B, emd, 25, 56, 56) out at the
reference's widths (12, 60, 300, 1500). Parameter names are the reference
implementation's (``conv1`` .. ``conv18``, ``dconv1`` .. ``dconv3`` with
the grouped ConvTranspose3d's (C, 1, 1, 3, 3) weight), so its checkpoints
and the golden ``tests/fixtures/unet3d_mala_small.npz`` load as they are.
The model has no BatchNorm and returns one tensor. ``dtype`` is the
compute dtype (:func:`.common.set_compute_dtype`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Conv3d, set_compute_dtype


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.005)


def _crop_concat(upsampled, bypass):
    """Center-crop the bypass to the upsampled tensor's (D, H, W), then
    concat along channels, upsampled first."""
    dz, dy, dx = ((b - u) // 2 for b, u in zip(bypass.shape[2:], upsampled.shape[2:]))
    d, h, w = bypass.shape[2:]
    return torch.cat([upsampled, bypass[:, :, dz:d - dz, dy:h - dy, dx:w - dx]], dim=1)


class DepthwiseTranspose(nn.Module):
    """The grouped (depthwise) transposed conv with kernel = stride =
    (1, 3, 3) and no bias: each voxel times its channel's 3x3 kernel fills a
    disjoint 3x3 block, computed as a broadcast multiply (exact), as JAX
    does. ``weight`` is (C, 1, 1, 3, 3), ConvTranspose3d(groups=C)'s."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, 1, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        b, c, d, h, w = x.shape
        k = self.weight[:, 0, 0].to(x.dtype).view(1, c, 1, 1, 3, 1, 3)
        return (x.view(b, c, d, h, 1, w, 1) * k).view(b, c, d, 3 * h, 3 * w)


class UNet3DMALADeep(nn.Module):
    """Returns the (B, emd, D', H', W') embedding of a (B, 1, D, H, W)
    volume, valid convolutions shrinking it (53x268x268 -> 25x56x56)."""

    def __init__(self, emd: int = 16, widths: Sequence[int] = (12, 60, 300, 1500),
                 in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        n1, n2, n3, n4 = widths
        convs = [(in_channels, n1, 3), (n1, n1, 3), (n1, n2, 3), (n2, n2, 3), (n2, n3, 3),
                 (n3, n3, 3), (n3, n4, 3), (n4, n4, 3), (n4, n3, 1), (2 * n3, n3, 3),
                 (n3, n3, 3), (n3, n2, 1), (2 * n2, n2, 3), (n2, n2, 3), (n2, n1, 1),
                 (2 * n1, n1, 3), (n1, n1, 3), (n1, emd, 1)]
        for i, (cin, cout, k) in enumerate(convs, start=1):
            setattr(self, f"conv{i}", Conv3d(cin, cout, k))
        for i, c in enumerate((n4, n3, n2), start=1):
            setattr(self, f"dconv{i}", DepthwiseTranspose(c))
        set_compute_dtype(self, dtype)

    def forward(self, x):
        def pool(v):
            return F.max_pool3d(v, (1, 3, 3))

        c2 = _lrelu(self.conv2(_lrelu(self.conv1(x))))
        c4 = _lrelu(self.conv4(_lrelu(self.conv3(pool(c2)))))
        c6 = _lrelu(self.conv6(_lrelu(self.conv5(pool(c4)))))
        c8 = _lrelu(self.conv8(_lrelu(self.conv7(pool(c6)))))
        m = _crop_concat(self.conv9(self.dconv1(c8)), c6)
        c11 = _lrelu(self.conv11(_lrelu(self.conv10(m))))
        m = _crop_concat(self.conv12(self.dconv2(c11)), c4)
        c14 = _lrelu(self.conv14(_lrelu(self.conv13(m))))
        m = _crop_concat(self.conv15(self.dconv3(c14)), c2)
        c17 = _lrelu(self.conv17(_lrelu(self.conv16(m))))
        return self.conv18(c17)
