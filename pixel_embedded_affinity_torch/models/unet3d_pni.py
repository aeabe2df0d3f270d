"""PNI "superhuman" anisotropic 3D UNet with deep supervision (NCDHW).

1x5x5 in/out convs (conv + ELU, no BN); four (1, 2, 2) max-pool stages of
residual blocks (1x3x3 conv-BN-ELU, then 3x3x3 conv-BN-ELU-3x3x3 conv, the
two added, BN, ELU); (1, 2, 2) trilinear align-corners upsampling with a
1x1x1 conv, merged with the skip by addition, then BN + ELU; five 1x1x1
embedding heads. The port of the JAX package's ``models/unet3d_pni.py``.
Parameter names are the reference implementation's (``embed_in.0``,
``conv0.block1.0``, ``up0.1``, ``cat0.0``, ``out_put.0``, ...), so its
checkpoints load as they are. BatchNorm momentum is the reference's 0.001
(Flax's ``bn_momentum_flax`` 0.999; another is 1 - it), and in train mode
the running statistics follow Flax's (:class:`.common.BatchNorm3d`). ``dtype`` is the compute dtype
(:func:`.common.set_compute_dtype`), as in the 2D model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm3d, Conv3d, set_compute_dtype, upsample_xy_align_corners

BN_MOMENTUM = 0.001


def _bn(ch: int, bn_momentum_flax: float) -> BatchNorm3d:
    # torch's momentum is 1 - Flax's, rounded so that 0.999 gives 0.001
    return BatchNorm3d(ch, eps=1e-5, momentum=round(1.0 - bn_momentum_flax, 15))


class ResBlockPNI(nn.Module):
    """1x3x3 conv-BN-ELU; + (3x3x3 conv-BN-ELU, 3x3x3 conv); add; BN; ELU."""

    def __init__(self, in_ch: int, out_ch: int, bn_momentum_flax: float = 1 - BN_MOMENTUM):
        super().__init__()
        m = bn_momentum_flax
        self.block1 = nn.Sequential(
            Conv3d(in_ch, out_ch, (1, 3, 3), padding=(0, 1, 1), bias=False),
            _bn(out_ch, m), nn.ELU(inplace=True))
        self.block2 = nn.Sequential(
            Conv3d(out_ch, out_ch, 3, padding=1, bias=False), _bn(out_ch, m),
            nn.ELU(inplace=True),
            Conv3d(out_ch, out_ch, 3, padding=1, bias=False))
        self.block3 = _bn(out_ch, m)

    def forward(self, x):
        r = self.block1(x)
        return F.elu(self.block3(r + self.block2(r)), inplace=True)


class UpsampleConv(nn.Sequential):
    """(1, 2, 2) align-corners upsampling, then a 1x1x1 conv with bias."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(UpsampleXY(), Conv3d(in_ch, out_ch, 1))


class UpsampleXY(nn.Module):
    def forward(self, x):
        return upsample_xy_align_corners(x)


class MergeBNELU(nn.Sequential):
    """BN + ELU of the added merge."""

    def __init__(self, ch: int, bn_momentum_flax: float = 1 - BN_MOMENTUM):
        super().__init__(_bn(ch, bn_momentum_flax), nn.ELU(inplace=True))


class UNetPNIEmbeddingDeep(nn.Module):
    """Returns (out1 (1/16 in y, x), out2 (1/8), out3 (1/4), out4 (1/2),
    embedding (1/1)), each NCDHW with ``emd`` channels in the compute
    ``dtype``; z keeps its size. ``bn_momentum_flax``: every BatchNorm's
    momentum, Flax's convention."""

    def __init__(self, in_channels: int = 1,
                 filters: Sequence[int] = (28, 36, 48, 64, 80), emd: int = 16,
                 dtype=torch.float32, bn_momentum_flax: float = 1 - BN_MOMENTUM):
        super().__init__()
        f = [filters[0]] + list(filters)
        m = bn_momentum_flax
        self.embed_in = nn.Sequential(
            Conv3d(in_channels, f[0], (1, 5, 5), padding=(0, 2, 2)),
            nn.ELU(inplace=True))
        self.conv0 = ResBlockPNI(f[0], f[1], m)
        self.conv1 = ResBlockPNI(f[1], f[2], m)
        self.conv2 = ResBlockPNI(f[2], f[3], m)
        self.conv3 = ResBlockPNI(f[3], f[4], m)
        self.center = ResBlockPNI(f[4], f[5], m)
        self.up0 = UpsampleConv(f[5], f[4])
        self.cat0 = MergeBNELU(f[4], m)
        self.conv4 = ResBlockPNI(f[4], f[4], m)
        self.up1 = UpsampleConv(f[4], f[3])
        self.cat1 = MergeBNELU(f[3], m)
        self.conv5 = ResBlockPNI(f[3], f[3], m)
        self.up2 = UpsampleConv(f[3], f[2])
        self.cat2 = MergeBNELU(f[2], m)
        self.conv6 = ResBlockPNI(f[2], f[2], m)
        self.up3 = UpsampleConv(f[2], f[1])
        self.cat3 = MergeBNELU(f[1], m)
        self.conv7 = ResBlockPNI(f[1], f[1], m)
        self.embed_out = nn.Sequential(
            Conv3d(f[1], f[0], (1, 5, 5), padding=(0, 2, 2)),
            nn.ELU(inplace=True))
        self.out_put = nn.Sequential(Conv3d(f[0], emd, 1))
        self.out_put1 = nn.Sequential(Conv3d(f[5], emd, 1))
        self.out_put2 = nn.Sequential(Conv3d(f[4], emd, 1))
        self.out_put3 = nn.Sequential(Conv3d(f[3], emd, 1))
        self.out_put4 = nn.Sequential(Conv3d(f[2], emd, 1))
        set_compute_dtype(self, dtype)

    def forward(self, x):
        def pool(v):
            return F.max_pool3d(v, (1, 2, 2))

        conv0 = self.conv0(self.embed_in(x))
        conv1 = self.conv1(pool(conv0))
        conv2 = self.conv2(pool(conv1))
        conv3 = self.conv3(pool(conv2))
        center = self.center(pool(conv3))
        conv4 = self.conv4(self.cat0(self.up0(center) + conv3))
        conv5 = self.conv5(self.cat1(self.up1(conv4) + conv2))
        conv6 = self.conv6(self.cat2(self.up2(conv5) + conv1))
        conv7 = self.conv7(self.cat3(self.up3(conv6) + conv0))
        out = self.out_put(self.embed_out(conv7))
        return (self.out_put1(center), self.out_put2(conv4), self.out_put3(conv5),
                self.out_put4(conv6), out)
