"""UNet_PNI_embedding_deep, plain: the AC3/AC4 model of Pixel-Embedded
Affinity (the reference's ``scripts_ac3ac4/model/model_superhuman.py``),
NCDHW.

1x5x5 in and out convs with ELU; four (1, 2, 2) max-pool stages of residual
blocks (1x3x3 conv-BN-ELU, then 3x3x3 conv-BN-ELU-3x3x3 conv, the two added,
BN, ELU); (1, 2, 2) trilinear align-corners upsampling and a 1x1x1 conv,
added to the skip, then BN and ELU; five 1x1x1 embedding heads. BatchNorm
eps 1e-5. Parameter names are the reference implementation's.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

NO_GRADIENT = ()


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block1 = nn.Sequential(nn.Conv3d(cin, cout, (1, 3, 3), padding=(0, 1, 1), bias=False),
                                    nn.BatchNorm3d(cout), nn.ELU())
        self.block2 = nn.Sequential(nn.Conv3d(cout, cout, 3, padding=1, bias=False),
                                    nn.BatchNorm3d(cout), nn.ELU(),
                                    nn.Conv3d(cout, cout, 3, padding=1, bias=False))
        self.block3 = nn.BatchNorm3d(cout)

    def forward(self, x):
        r = self.block1(x)
        return F.elu(self.block3(r + self.block2(r)))


class Up(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=(1, 2, 2), mode="trilinear", align_corners=True)


class Model(nn.Module):
    """Returns (out1 (1/16 in y, x), out2, out3, out4 (1/2), embedding)."""

    def __init__(self, input_nc: int = 1, filters=(28, 36, 48, 64, 80), emd: int = 16):
        super().__init__()
        f = [filters[0]] + list(filters)
        self.embed_in = nn.Sequential(nn.Conv3d(input_nc, f[0], (1, 5, 5), padding=(0, 2, 2)),
                                      nn.ELU())
        self.conv0, self.conv1 = ResBlock(f[0], f[1]), ResBlock(f[1], f[2])
        self.conv2, self.conv3 = ResBlock(f[2], f[3]), ResBlock(f[3], f[4])
        self.center = ResBlock(f[4], f[5])
        for i, (cin, cout) in enumerate([(f[5], f[4]), (f[4], f[3]), (f[3], f[2]), (f[2], f[1])]):
            setattr(self, f"up{i}", nn.Sequential(Up(), nn.Conv3d(cin, cout, 1)))
            setattr(self, f"cat{i}", nn.Sequential(nn.BatchNorm3d(cout), nn.ELU()))
            setattr(self, f"conv{4 + i}", ResBlock(cout, cout))
        self.embed_out = nn.Sequential(nn.Conv3d(f[1], f[0], (1, 5, 5), padding=(0, 2, 2)),
                                       nn.ELU())
        self.out_put = nn.Sequential(nn.Conv3d(f[0], emd, 1))
        self.out_put1 = nn.Sequential(nn.Conv3d(f[5], emd, 1))
        self.out_put2 = nn.Sequential(nn.Conv3d(f[4], emd, 1))
        self.out_put3 = nn.Sequential(nn.Conv3d(f[3], emd, 1))
        self.out_put4 = nn.Sequential(nn.Conv3d(f[2], emd, 1))

    def forward(self, x):
        def pool(v):
            return F.max_pool3d(v, (1, 2, 2))

        c0 = self.conv0(self.embed_in(x))
        c1 = self.conv1(pool(c0))
        c2 = self.conv2(pool(c1))
        c3 = self.conv3(pool(c2))
        center = self.center(pool(c3))
        c4 = self.conv4(self.cat0(self.up0(center) + c3))
        c5 = self.conv5(self.cat1(self.up1(c4) + c2))
        c6 = self.conv6(self.cat2(self.up2(c5) + c1))
        c7 = self.conv7(self.cat3(self.up3(c6) + c0))
        out = self.out_put(self.embed_out(c7))
        return self.out_put1(center), self.out_put2(c4), self.out_put3(c5), self.out_put4(c6), out


def build(model_cfg: dict) -> Model:
    return Model(model_cfg["input_nc"], tuple(model_cfg["filters"]), model_cfg["emd"])


def forward_flops(model_cfg: dict, batch: int, spatial) -> int:
    """2 x the conv MACs of one forward at (batch, *spatial)."""
    from ..flops import unet3d_pni_flops

    return unet3d_pni_flops(batch, *spatial, in_ch=model_cfg["input_nc"],
                            filters=tuple(model_cfg["filters"]), emd=model_cfg["emd"],
                            act_bytes=4)[0]
