"""ResUNet-2D-deep, plain: the CVPPP model of Pixel-Embedded Affinity
(the reference's ``scripts_cvppp/model/unet2d_residual.py``), NCHW.

Residual conv-BN-ReLU blocks with a conv-BN projection skip, a max-pool
encoder over five scales, an x2 bilinear (align-corners) decoder with
concatenated skips, five 1x1 embedding heads (1/16 .. 1/1) and a binary mask
head. Parameter names are the reference implementation's, so a state dict
loads into the program's model and into this one alike.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# the mask head's output takes no loss in the CVPPP step, so its convs get
# no gradient
NO_GRADIENT = ("binary_seg.",)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout),
                                  nn.ReLU(), nn.Conv2d(cout, cout, 3, padding=1),
                                  nn.BatchNorm2d(cout))
        self.project = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout))

    def forward(self, x):
        return F.relu(self.conv(x) + self.project(x))


class Wrap(nn.Module):
    """A block under the reference's attribute name (``conv`` or ``block``)."""

    def __init__(self, name: str, cin: int, cout: int, pool: bool = False, up: bool = False):
        super().__init__()
        setattr(self, name, ResidualBlock(cin, cout))
        self.name, self.pool, self.up = name, pool, up

    def forward(self, x):
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        x = getattr(self, self.name)(x)
        return F.max_pool2d(x, 2) if self.pool else x


class Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


def _cat(y, skip):
    ph, pw = skip.shape[-2] - y.shape[-2], skip.shape[-1] - y.shape[-1]
    if ph or pw:
        y = F.pad(y, (0, pw, 0, ph), mode="replicate")
    return torch.cat([y, skip], dim=1)


class Model(nn.Module):
    """Returns (out1 (1/16) .. out4 (1/2), embedding (1/1), mask logits)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 2,
                 filters=(16, 32, 64, 128, 256), emd: int = 16):
        super().__init__()
        f = list(filters)
        self.inconv = Wrap("conv", input_nc, f[0])
        self.down1 = Wrap("block", f[0], f[1], pool=True)
        self.down2 = Wrap("block", f[1], f[2], pool=True)
        self.down3 = Wrap("block", f[2], f[3], pool=True)
        self.down4 = Wrap("block", f[3], f[4], pool=True)
        self.up1_emb = Wrap("block", f[4], f[4], up=True)
        self.up2_emb = Wrap("block", f[4] + f[3], f[3], up=True)
        self.up3_emb = Wrap("block", f[3] + f[2], f[2], up=True)
        self.up4_emb = Wrap("block", f[2] + f[1], f[1], up=True)
        self.outconv1 = Head(f[4], emd)
        self.outconv2 = Head(f[4], emd)
        self.outconv3 = Head(f[3], emd)
        self.outconv4 = Head(f[2], emd)
        self.outconv_emb = Head(f[1], emd)
        self.binary_seg = nn.Sequential(nn.Conv2d(f[1], f[1], 1), nn.BatchNorm2d(f[1]),
                                        nn.ReLU(), nn.Conv2d(f[1], output_nc, 1))

    def forward(self, x):
        x1 = self.inconv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1_emb(x5)
        out2 = self.outconv2(y)
        y = self.up2_emb(_cat(y, x4))
        out3 = self.outconv3(y)
        y = self.up3_emb(_cat(y, x3))
        out4 = self.outconv4(y)
        y = self.up4_emb(_cat(y, x2))
        return (self.outconv1(x5), out2, out3, out4, self.outconv_emb(y), self.binary_seg(y))


def build(model_cfg: dict) -> Model:
    return Model(model_cfg["input_nc"], model_cfg["output_nc"], tuple(model_cfg["filters"]),
                 model_cfg["emd"])


def forward_flops(model_cfg: dict, batch: int, spatial) -> int:
    """2 x the conv MACs of one forward at (batch, *spatial)."""
    from ..flops import resunet2d_flops

    return resunet2d_flops(batch, *spatial, in_ch=model_cfg["input_nc"],
                           nfeatures=tuple(model_cfg["filters"]), emd=model_cfg["emd"],
                           mask_classes=model_cfg["output_nc"], act_bytes=4)[0]
