"""ResNet-50/101 pixel-embedding networks (NCHW), the port of the JAX
package's ``models/resnet_embed.py``.

A bottleneck ResNet encoder of stride 16 (layer4 at stride 1), an optional
windowed local-attention block after layer4, and a light decoder (x2
align-corners upsampling, concat with the encoder's skip, 3x3 conv, BN,
ReLU) emitting :class:`.ResidualUNet2DDeep`'s outputs: (emb 1/16, 1/8,
1/4, 1/2, embedding 1/1, mask logits). Module names are the JAX scopes
(``conv1``, ``bn1``, ``layer1_0`` .. ``layer4_2``, ``layer4_attn``,
``outconv1`` .. ``outconv_emb``, ``up1_conv``/``up1_bn`` ..
``up4_conv``/``up4_bn``, ``mask_conv1``/``mask_bn``/``mask_conv2``), so a
Flax tree maps onto the state dict by its paths
(:func:`..convert.resnet_embedding_from_flax`). BatchNorm keeps Flax's
running statistics (:class:`.common.BatchNorm2d`, Flax momentum 0.9 =
torch 0.1). ``dtype`` is the compute dtype
(:func:`.common.set_compute_dtype`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm2d, Conv2d, set_compute_dtype, upsample_align_corners

LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """1x1 - 3x3 (stride) - 1x1 (x4) convs with BN, the identity or a
    strided 1x1 projection (``proj``, ``proj_bn``) added, then ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 use_projection: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        if use_projection:
            self.proj = Conv2d(in_ch, planes * 4, 1, stride=stride, bias=False)
            self.proj_bn = _bn(planes * 4)
        self.use_projection = use_projection

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = self.proj_bn(self.proj(x)) if self.use_projection else x
        return F.relu(out + sc)


class LocalAttentionBlock(nn.Module):
    """Multi-head self-attention inside non-overlapping ``window`` x
    ``window`` patches: a 1x1 ``qkv`` conv, softmax(q k^T / sqrt(d)) v per
    window and head, a 1x1 ``proj`` conv, BN, and ReLU of the sum with the
    input. The window must divide H and W."""

    def __init__(self, in_ch: int, planes: int, heads: int = 8, window: int = 8):
        super().__init__()
        self.planes, self.heads, self.window = planes, heads, window
        self.qkv = Conv2d(in_ch, 3 * planes, 1, bias=False)
        self.proj = Conv2d(planes, in_ch, 1, bias=False)
        self.bn = _bn(in_ch)

    def forward(self, x):
        b, _, h, w = x.shape
        win, heads = self.window, self.heads
        if h % win or w % win:
            raise ValueError(f"window {win} must divide the spatial dims {h}x{w}")
        dh = self.planes // heads
        nh, nw = h // win, w // win

        def windows(t):  # (b, heads*dh, h, w) -> (b, nh*nw, heads, win*win, dh)
            t = t.reshape(b, heads, dh, nh, win, nw, win).permute(0, 3, 5, 1, 4, 6, 2)
            return t.reshape(b, nh * nw, heads, win * win, dh)

        q, k, v = (windows(t) for t in self.qkv(x).chunk(3, dim=1))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
        out = torch.matmul(attn, v).reshape(b, nh, nw, heads, win, win, dh)
        out = out.permute(0, 3, 6, 1, 4, 2, 5).reshape(b, self.planes, h, w)
        return F.relu(x + self.bn(self.proj(out)))


class ResNetEmbedding(nn.Module):
    """ResNet-``depth`` (50 or 101) encoder and decoder with five ``emd``-
    channel embedding heads and an ``out_channels`` mask head; returns
    (emb 1/16, 1/8, 1/4, 1/2, embedding 1/1, mask logits), all NCHW in the
    compute ``dtype``. H and W must divide by 16."""

    def __init__(self, depth: int = 50, emd: int = 16, out_channels: int = 2,
                 local_attention: bool = False, in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        if depth not in LAYERS:
            raise ValueError(f"depth {depth}: expected one of {sorted(LAYERS)}")
        layers = LAYERS[depth]
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        in_ch = 64
        self.stages = []
        for s, (planes, blocks, stride) in enumerate(zip((64, 128, 256, 512), layers,
                                                         (1, 2, 2, 1)), start=1):
            names = []
            for i in range(blocks):
                setattr(self, f"layer{s}_{i}", Bottleneck(
                    in_ch, planes, stride if i == 0 else 1, use_projection=i == 0))
                in_ch = planes * 4
                names.append(f"layer{s}_{i}")
            self.stages.append(names)
        self.local_attention = local_attention
        if local_attention:
            self.layer4_attn = LocalAttentionBlock(2048, 512)
        for i, c in enumerate((2048, 256, 128, 64), start=1):
            setattr(self, f"outconv{i}", Conv2d(c, emd, 1))
        for i, (cin, cout) in enumerate(((2048 + 512, 256), (256 + 256, 128), (128 + 64, 64),
                                         (64, 64)), start=1):
            setattr(self, f"up{i}_conv", Conv2d(cin, cout, 3, padding=1, bias=False))
            setattr(self, f"up{i}_bn", _bn(cout))
        self.outconv_emb = Conv2d(64, emd, 1)
        self.mask_conv1 = Conv2d(64, 64, 1)
        self.mask_bn = _bn(64)
        self.mask_conv2 = Conv2d(64, out_channels, 1)
        set_compute_dtype(self, dtype)

    def _stage(self, y, s: int):
        for name in self.stages[s]:
            y = getattr(self, name)(y)
        return y

    def _up(self, y, i: int, skip=None):
        y = upsample_align_corners(y)
        if skip is not None:
            y = torch.cat([y, skip], dim=1)
        return F.relu(getattr(self, f"up{i}_bn")(getattr(self, f"up{i}_conv")(y)))

    def forward(self, x):
        c1 = F.relu(self.bn1(self.conv1(x)))                     # /2
        y = F.max_pool2d(c1, 3, stride=2, padding=1)            # -inf padding
        c2 = self._stage(y, 0)                                   # /4
        c3 = self._stage(c2, 1)                                  # /8
        c4 = self._stage(c3, 2)                                  # /16
        c5 = self._stage(c4, 3)                                  # /16 (stride 1)
        if self.local_attention:
            c5 = self.layer4_attn(c5)
        out1 = self.outconv1(c5)
        d = self._up(c5, 1, c3)                                  # /8
        out2 = self.outconv2(d)
        d = self._up(d, 2, c2)                                   # /4
        out3 = self.outconv3(d)
        d = self._up(d, 3, c1)                                   # /2
        out4 = self.outconv4(d)
        d = self._up(d, 4)                                       # /1
        embedding = self.outconv_emb(d)
        mask = self.mask_conv2(F.relu(self.mask_bn(self.mask_conv1(d))))
        return out1, out2, out3, out4, embedding, mask
