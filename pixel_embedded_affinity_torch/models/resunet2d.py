"""ResUNet-2D with deep supervision (NCHW), and its single-head variant.

Residual conv-BN-ReLU blocks with a conv-BN projection skip, a maxpool
encoder over 5 scales, a bilinear (align_corners=True) decoder with concat
skips, five 1x1 embedding heads (1/16, 1/8, 1/4, 1/2, 1/1) and a binary
mask head. BatchNorm keeps Flax's running statistics in train mode
(:class:`.common.BatchNorm2d`). Parameter names follow the reference implementation
(``inconv.conv.conv.0.weight``, ``up1_emb.block...``, ``binary_seg.{0,1,3}``),
so its checkpoints load as they are. ``dtype`` is the compute dtype
(:func:`.common.set_compute_dtype`): with bfloat16 every output is
bfloat16 and the parameters stay float32, as in the JAX package's model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (BatchNorm2d, Conv2d, replication_pad_to, set_compute_dtype,
                     upsample_align_corners)


class ResidualBlock(nn.Module):
    """(conv3x3-BN-ReLU-conv3x3-BN) + (conv3x3-BN skip), then ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch))
        self.project = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm2d(out_ch))

    def forward(self, x):
        return F.relu(self.conv(x) + self.project(x))


class InConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = ResidualBlock(in_ch, out_ch)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = ResidualBlock(in_ch, out_ch)

    def forward(self, x):
        return F.max_pool2d(self.block(x), 2)


class Up(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = ResidualBlock(in_ch, out_ch)

    def forward(self, x):
        return self.block(upsample_align_corners(x))


class OutConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        return self.conv(x)


class MaskHead(nn.Sequential):
    """1x1 conv - BN - ReLU - 1x1 conv binary segmentation head."""

    def __init__(self, in_ch: int, hidden: int, out_ch: int):
        super().__init__(Conv2d(in_ch, hidden, 1), BatchNorm2d(hidden),
                         nn.ReLU(inplace=True), Conv2d(hidden, out_ch, 1))


def _concat_skip(x_cur, x_prev):
    """Concat along channels, edge-padding x_cur up to x_prev's spatial size."""
    x_cur = replication_pad_to(x_cur, x_prev.shape[-2], x_prev.shape[-1])
    return torch.cat([x_cur, x_prev], dim=1)


class ResidualUNet2DDeep(nn.Module):
    """Returns (emb1..emb4, embedding, mask_logits), all NCHW: emb1 at 1/16
    scale ... embedding at full scale, each ``emd`` channels; mask_logits
    has ``out_channels`` classes; all in the compute ``dtype``."""

    def __init__(self, in_channels: int = 3, out_channels: int = 2,
                 nfeatures: Sequence[int] = (16, 32, 64, 128, 256),
                 emd: int = 16, dtype=torch.float32):
        super().__init__()
        f = list(nfeatures)
        self.inconv = InConv(in_channels, f[0])
        self.down1 = Down(f[0], f[1])
        self.down2 = Down(f[1], f[2])
        self.down3 = Down(f[2], f[3])
        self.down4 = Down(f[3], f[4])
        self.up1_emb = Up(f[4], f[4])
        self.up2_emb = Up(f[4] + f[3], f[3])
        self.up3_emb = Up(f[3] + f[2], f[2])
        self.up4_emb = Up(f[2] + f[1], f[1])
        self.outconv1 = OutConv(f[4], emd)
        self.outconv2 = OutConv(f[4], emd)
        self.outconv3 = OutConv(f[3], emd)
        self.outconv4 = OutConv(f[2], emd)
        self.outconv_emb = OutConv(f[1], emd)
        self.binary_seg = MaskHead(f[1], f[1], out_channels)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        x1 = self.inconv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        out1 = self.outconv1(x5)

        y = self.up1_emb(x5)
        out2 = self.outconv2(y)
        y = self.up2_emb(_concat_skip(y, x4))
        out3 = self.outconv3(y)
        y = self.up3_emb(_concat_skip(y, x3))
        out4 = self.outconv4(y)
        y = self.up4_emb(_concat_skip(y, x2))
        embedding = self.outconv_emb(y)
        mask = self.binary_seg(y)
        return out1, out2, out3, out4, embedding, mask


class ResidualUNet2D(nn.Module):
    """The single-head variant (the reference's ResidualUNet2D_embedding):
    the same encoder and decoder without the four deep-supervision heads.
    Returns (embedding, mask_logits), NCHW, in the compute ``dtype``."""

    def __init__(self, in_channels: int = 3, out_channels: int = 2,
                 nfeatures: Sequence[int] = (16, 32, 64, 128, 256),
                 emd: int = 16, dtype=torch.float32):
        super().__init__()
        f = list(nfeatures)
        self.inconv = InConv(in_channels, f[0])
        self.down1 = Down(f[0], f[1])
        self.down2 = Down(f[1], f[2])
        self.down3 = Down(f[2], f[3])
        self.down4 = Down(f[3], f[4])
        self.up1_emb = Up(f[4], f[4])
        self.up2_emb = Up(f[4] + f[3], f[3])
        self.up3_emb = Up(f[3] + f[2], f[2])
        self.up4_emb = Up(f[2] + f[1], f[1])
        self.outconv_emb = OutConv(f[1], emd)
        self.binary_seg = MaskHead(f[1], f[1], out_channels)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        x2 = self.down1(self.inconv(x))
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up1_emb(self.down4(x4))
        y = self.up2_emb(_concat_skip(y, x4))
        y = self.up3_emb(_concat_skip(y, x3))
        y = self.up4_emb(_concat_skip(y, x2))
        return self.outconv_emb(y), self.binary_seg(y)
