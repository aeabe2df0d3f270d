"""Folded-BatchNorm serving forward of :class:`.UNetPNIEmbeddingDeep`, the
port of the JAX package's ``models/fast_forward3d.py``.

``build_fast_pni_forward(model)`` takes an eval-mode model and returns
``fn(x) -> embedding``, (B, D, H, W, Cin) -> (B, D, H, W, emd), equal to
the model's output 4 (its last) permuted to channels-last, with:

* the volume viewed as B*D images (a merged batch) and every conv a 2D
  conv on it: a 3x3x3 conv becomes one 3x3 conv over the z-concatenated
  channels [x(z-1), x(z), x(z+1)], zero at the volume's ends (the 3D
  conv's zero padding in z), its kernel the three z taps stacked along
  the input channels; the 1x3x3, 1x5x5 and 1x1x1 convs are plain 2D
  convs of each slice;
* inference BatchNorm folded into the conv weights (the scale into the
  output channels, the shift as the conv's bias); a block's ``bn_out``
  (``block3``) scales conv2 and the residual, so the block ends
  ELU(r * scale + conv2'(y) + shift);
* the (1, 2, 2) max-pools as 2D pools, and the xy-only align-corners
  upsampling as two products with interpolation matrices (rows, then
  columns);
* the four deep-supervision heads dropped: serving reads the embedding
  only.

Activations are NCHW-contiguous (B*D, C, H, W); the convs go to
``F.conv2d`` in full float32 (TF32 off, :func:`..device.float32_convs`),
or in ``dtype`` with the biases added in it, as the JAX function computes
in its ``dtype``. The embedding reaches the 3D affinity kernel K5f as a
(B, D, H, W, emd) view of the (B*D, emd, H, W) output: channel stride
H*W, x stride 1, the strided load path K5f takes for the dense module's
NCDHW output too (not its channels-last ``kContig`` path). ``emb_f32``
(the default) casts the embedding to float32 first, as the JAX package
serves.

JAX parameter scopes are the reference's module names, which the port's
model keeps: in a block ``conv_in``/``bn_in`` are ``block1.0``/``.1``,
``conv1``/``bn1`` ``block2.0``/``.1``, ``conv2`` ``block2.3`` and
``bn_out`` ``block3``; ``up{i}``'s conv is ``up{i}.1``, ``cat{i}``'s
BatchNorm ``cat{i}.0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import float32_convs
from .common import DTYPES
from .fast_forward import _fold_bn, _interp_matrix

BLOCKS = ("conv0", "conv1", "conv2", "conv3", "center", "conv4", "conv5", "conv6", "conv7")


def _zconcat(x: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """(B*D, C, H, W) -> (B*D, 3C, H, W): channels [z-1, z, z+1], zero at
    the volume's ends."""
    bd, c, h, w = x.shape
    v = x.view(b, d, c, h, w)
    out = x.new_zeros((b, d, 3, c, h, w))
    out[:, 1:, 0] = v[:, :-1]
    out[:, :, 1] = v
    out[:, :-1, 2] = v[:, 1:]
    return out.view(bd, 3 * c, h, w)


def _k3d_to_2d(weight: torch.Tensor) -> torch.Tensor:
    """(O, I, 3, ky, kx) -> (O, 3I, ky, kx) in :func:`_zconcat`'s channel
    order: the z tap 0 reads slice z - 1."""
    return torch.cat([weight[:, :, 0], weight[:, :, 1], weight[:, :, 2]], dim=1)


class _PNIBlockW:
    """The folded weights of one ResBlockPNI in 2D-conv form, and its
    forward on the merged batch."""

    def __init__(self, block, dtype):
        conv_in, bn_in = block.block1[0], block.block1[1]
        conv1, bn1, conv2 = block.block2[0], block.block2[1], block.block2[3]
        sc, sh = _fold_bn(bn_in)
        self.w_in = (conv_in.weight.float()[:, :, 0] * sc[:, None, None, None]).to(dtype)
        self.b_in = sh.to(dtype)
        sc, sh = _fold_bn(bn1)
        self.w1 = _k3d_to_2d(conv1.weight.float() * sc[:, None, None, None, None]).to(dtype)
        self.b1 = sh.to(dtype)
        # ELU(bn_out(r + conv2)) = ELU(r * scale + conv2[w * scale] + shift)
        sc, sh = _fold_bn(block.block3)
        self.w2 = _k3d_to_2d(conv2.weight.float() * sc[:, None, None, None, None]).to(dtype)
        self.b2 = sh.to(dtype)
        self.scale_r = sc.to(dtype)[:, None, None]

    def __call__(self, x, b, d):
        r = F.elu(F.conv2d(x, self.w_in, self.b_in, padding=1), inplace=True)
        y = F.elu(F.conv2d(_zconcat(r, b, d), self.w1, self.b1, padding=1), inplace=True)
        y = F.conv2d(_zconcat(y, b, d), self.w2, self.b2, padding=1)
        return F.elu(y.addcmul_(r, self.scale_r), inplace=True)


def _conv1x1(conv, dtype):
    """A 1x1x1 Conv3d's (weight (O, I, 1, 1), bias) in 2D form."""
    return conv.weight.float()[:, :, 0].to(dtype), conv.bias.float().to(dtype)


_MATRICES: dict = {}


def _matrix(n: int, like: torch.Tensor) -> torch.Tensor:
    """The (2n, n) align-corners interpolation matrix on ``like``'s device
    and in its dtype, made once (a forward then copies nothing from the
    host, and can be captured in a CUDA graph)."""
    key = (n, like.device, like.dtype)
    m = _MATRICES.get(key)
    if m is None:
        m = _MATRICES[key] = torch.from_numpy(_interp_matrix(2 * n, n)).to(like.device, like.dtype)
    return m


def _upsample2x_xy(y: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, 2h, 2w), align-corners bilinear: rows, then
    columns."""
    h, w = y.shape[-2:]
    return torch.matmul(torch.matmul(_matrix(h, y), y), _matrix(w, y).t())


def build_fast_pni_forward(model, *, dtype=torch.float32, emb_f32: bool = True):
    """``fn(x: (B, D, H, W, Cin)) -> (B, D, H, W, emd)`` from an eval-mode
    :class:`.UNetPNIEmbeddingDeep` (its weights and running statistics are
    read once, here). ``dtype``: the compute dtype, a torch dtype or
    "float32" / "bfloat16"; ``emb_f32``: the embedding cast to float32.
    The graph is the module docstring's; x lies on the model's device."""
    dt = DTYPES[dtype] if isinstance(dtype, str) else dtype
    with torch.no_grad():
        blocks = {k: _PNIBlockW(getattr(model, k), dt) for k in BLOCKS}
        e_in = model.embed_in[0]
        w_ein = e_in.weight.float()[:, :, 0].to(dt)
        b_ein = e_in.bias.float().to(dt)
        ups = {i: _conv1x1(getattr(model, f"up{i}")[1], dt) for i in range(4)}
        cats = {i: tuple(t.to(dt)[:, None, None] for t in _fold_bn(getattr(model, f"cat{i}")[0]))
                for i in range(4)}
        e_out = model.embed_out[0]
        w_eout = e_out.weight.float()[:, :, 0].to(dt)
        b_eout = e_out.bias.float().to(dt)
        w_head, b_head = _conv1x1(model.out_put[0], dt)

    def up_merge(v, skip, i):
        wk, bk = ups[i]
        u = F.conv2d(_upsample2x_xy(v), wk, bk)
        sc, sh = cats[i]
        return F.elu((u + skip).mul_(sc).add_(sh), inplace=True)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, cin = x.shape
        y = x.permute(0, 1, 4, 2, 3).reshape(b * d, cin, h, w).to(dt)
        with float32_convs():
            y = F.elu(F.conv2d(y, w_ein, b_ein, padding=2), inplace=True)
            c0 = blocks["conv0"](y, b, d)
            c1 = blocks["conv1"](F.max_pool2d(c0, 2), b, d)
            c2 = blocks["conv2"](F.max_pool2d(c1, 2), b, d)
            c3 = blocks["conv3"](F.max_pool2d(c2, 2), b, d)
            ce = blocks["center"](F.max_pool2d(c3, 2), b, d)
            v = blocks["conv4"](up_merge(ce, c3, 0), b, d)
            v = blocks["conv5"](up_merge(v, c2, 1), b, d)
            v = blocks["conv6"](up_merge(v, c1, 2), b, d)
            v = blocks["conv7"](up_merge(v, c0, 3), b, d)
            eo = F.elu(F.conv2d(v, w_eout, b_eout, padding=2), inplace=True)
            emb = F.conv2d(eo, w_head, b_head)
        if emb_f32:
            emb = emb.float()
        return emb.view(b, d, -1, h, w).permute(0, 1, 3, 4, 2)

    return forward
