"""Folded-BatchNorm inference forward of :class:`.ResidualUNet2DDeep`, the
port of the JAX package's ``models/fast_forward.py``.

``build_fast_resunet_forward(model)`` returns ``fn(image) -> (embedding,
mask_logits)`` equal to the eval-mode model's outputs 4 and 5, in the JAX
package's NHWC layout, with:

* inference BatchNorm folded into the convolutions (the scale into the
  weights, the shift into a per-channel add after the conv);
* the high-resolution stages in space-to-depth form (:mod:`..ops.s2d`), in
  one of three exact forms per stage: ``"dense"`` (a 3x3 block-space
  conv), ``"2x2"`` (two parity convs per conv, one per x output parity)
  and ``"pallas"``, the whole residual block as one launch of the K8
  kernel (:func:`..ops.s2d_block_cuda.fused_s2d_block`, its plain version
  on a CPU tensor);
* the 2x2 max-pool of an s2d stage as a max over its parity groups, and
  the align-corners x2 upsampling into an s2d stage as per-parity
  interpolation-matrix products (the full-resolution tensor is never
  formed);
* decoder skip concats kept virtual: a split block convolves its two
  inputs with the two halves of its weights.

Activations are NHWC-contiguous; the direct, dense and 2x2 convs go to
``F.conv2d`` through the channels-last NCHW view (no copy), in full float32
(TF32 off, :func:`..device.float32_convs`), and the upsampling products
stay ``torch.einsum`` at float32 matmul precision.

int8 serving (``int8_sites`` with ``act_ranges``; the JAX package's
``model.int8_infer``): the named stage convs run as int8 x int8 -> int32
convolutions (:func:`..ops.quant.conv_i8`, the kernel I8c on the card),
their inputs quantized with one static scale per site
(:func:`..ops.quant.quantize_act`, I8q), their weights per output channel
over the prepared (folded, s2d) kernel; the rescale and the BatchNorm
shift are the conv's epilogue, in float32. ``collect_ranges`` makes the
forward also return max|x| (or with ``collect_quantile`` that quantile of
|x|) at every site, the calibration of :func:`calibrate_int8_ranges`.

JAX parameter scopes and the port's modules (the weights come across
through :func:`..convert.resunet2d_deep_from_flax`):

======================  ======================================
JAX scope               port module
======================  ======================================
``inconv``              ``inconv.conv``
``down1`` .. ``down4``  ``down1.block`` .. ``down4.block``
``up1`` .. ``up4``      ``up1_emb.block`` .. ``up4_emb.block``
``outconv_emb``         ``outconv_emb.conv``
``binary_seg``          ``binary_seg.0`` (conv1), ``.1`` (bn),
                        ``.3`` (conv2)
======================  ======================================

and inside a block ``conv1``/``bn1`` are ``conv.0``/``conv.1``,
``conv2``/``bn2`` ``conv.3``/``conv.4``, ``project_conv``/``project_bn``
``project.0``/``project.1``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import float32_convs
from ..ops.quant import (act_scale_from_absmax, conv_i8, pack_weights_i8, quantize_act,
                         quantize_weights_per_cout)
from ..ops.s2d import (depth_to_space, fuse_parity_groups, s2d_conv2x2_weights_qx,
                       s2d_conv_weights, space_to_depth)
from ..ops.s2d_block_cuda import block_taps, direct_taps, fused_s2d_block
from .common import replication_pad_to, upsample_align_corners

BLOCKS = {"inconv": "inconv.conv", "down1": "down1.block", "down2": "down2.block",
          "down3": "down3.block", "down4": "down4.block", "up1": "up1_emb.block",
          "up2": "up2_emb.block", "up3": "up3_emb.block", "up4": "up4_emb.block"}
# the JAX package's per-stage forms, tuned on its TPU; the direct-resolution
# stages are wired direct (form False), the others take and give s2d tensors
DEFAULT_FORMS = {"inconv": "dense", "down1": "dense", "down2": "2x2", "down3": False,
                 "down4": False, "up1": False, "up2": False, "up3": "2x2", "up4": "dense"}
DIRECT_STAGES = frozenset({"down3", "down4", "up1", "up2"})
S2D_FORMS = ("dense", "2x2", "pallas")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO weights as the channels-last OIHW tensor F.conv2d takes."""
    return w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv(x: torch.Tensor, w_oihw: torch.Tensor, pad=(1, 1, 1, 1)) -> torch.Tensor:
    """Conv of NHWC x with padding (left, right, top, bottom); NHWC out."""
    xc = _nchw(x)
    if pad[0] == pad[1] == pad[2] == pad[3]:
        return _nhwc(F.conv2d(xc, w_oihw, padding=pad[0]))
    return _nhwc(F.conv2d(F.pad(xc, pad), w_oihw))


# the parity-form convs of the "2x2" stages: H padded (1, 1), W (1, 0) for
# x output parity 0 and (0, 1) for parity 1; F.pad's order (left, right,
# top, bottom), and conv_i8's (top, bottom, left, right)
_PAD_QX = ((1, 0, 1, 1), (0, 1, 1, 1))
_PAD_QX_I8 = ((1, 1, 1, 0), (1, 1, 0, 1))

# the int8 sites the JAX package serves by default (its measured winners on
# its TPU): every stage conv but the thin-channel input convs of inconv,
# down1 and down3
INT8_DEFAULT_SITES = (
    "inconv.c2", "down1.c2", "down2.c1", "down2.c2", "down3.c2",
    "down4.c1", "down4.c2", "up1.c1", "up1.c2", "up2.c1", "up2.c2",
    "up3.c1", "up3.c2", "up4.c1", "up4.c2")


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q quantile of a 1-D tensor by linear interpolation, as
    ``jnp.quantile`` computes it in float32 (position q (n - 1), the two
    order statistics around it, weights 1 - f and f). The order statistics
    come from ``torch.kthvalue``: ``torch.quantile`` refuses more than 2^24
    elements, which a full-width site exceeds at one image."""
    n = x.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = np.float32(pos - low)
    w_low = np.float32(1) - w_high
    lo = int(min(max(low, 0), n - 1))
    hi = int(min(max(high, 0), n - 1))
    v_lo = torch.kthvalue(x, lo + 1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(x, hi + 1).values
    return v_lo * float(w_low) + v_hi * float(w_high)


def _quantized(w_hwio: torch.Tensor, sx: float):
    """(packed int8 weights, their float32 output scale s_w * s_x) of a
    float32 HWIO kernel whose input has the activation scale sx."""
    q, sw = quantize_weights_per_cout(w_hwio)
    return pack_weights_i8(q), sw * sx


def _map(fn, t):
    """fn of a tensor, or of each tensor of a tuple (a split block's parts)."""
    return tuple(fn(x) for x in t) if isinstance(t, tuple) else fn(t)


def _fold_bn(bn, conv_bias=None):
    """(scale, shift) of an eval-mode BatchNorm, the conv bias folded in."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    if conv_bias is not None:
        shift = shift + conv_bias * scale
    return scale.float(), shift.float()


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Align-corners linear interpolation matrix (n_out, n_in)."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1 - frac
    m[np.arange(n_out), hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _interp_on(n_out: int, n_in: int, device: torch.device, dtype) -> torch.Tensor:
    """_interp_matrix on ``device`` in ``dtype``, copied there once, so that
    a forward copies nothing from the host (and a CUDA graph captures it)."""
    return torch.from_numpy(_interp_matrix(n_out, n_in)).to(device=device, dtype=dtype)


def _upsample2x_to_s2d(y: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, W, C) -> the s2d view of its x2 align-corners upsampling,
    (B, H, W, 4C), channel order (qy, qx, c), by per-parity rows of the
    interpolation matrices."""
    b, h, w, c = y.shape
    my, mx = _interp_on(2 * h, h, y.device, dtype), _interp_on(2 * w, w, y.device, dtype)
    parts = []
    for qy in range(2):
        a = torch.einsum("oi,biwc->bowc", my[qy::2], y)
        for qx in range(2):
            parts.append(torch.einsum("oj,bhjc->bhoc", mx[qx::2], a))
    return torch.cat(parts, dim=-1)


def _upsample_direct(x: torch.Tensor) -> torch.Tensor:
    return _nhwc(upsample_align_corners(_nchw(x)))


def _pad_direct(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return _nhwc(replication_pad_to(_nchw(x), h, w))


class _BlockW:
    """The folded weights of one ResidualBlock in direct or s2d form, and
    the block's forward on NHWC tensors.

    ``s2d``: False (direct resolution), "dense", "2x2" or "pallas" (True
    means "dense"). ``split_at``: the input channel where the block's input
    is a virtual concat of two tensors; the block then takes a pair.

    ``int8_c1``/``int8_c2``: run conv1 (with the projection) or conv2 in
    int8, with the activation scales of the calibrated max|x| in ``scales``
    ("c1", "c1b" for a split block's second part, "c2"). ``collect``: a
    dict the forward fills with the calibration statistic of each site,
    named "<name>.c1" ("<name>.c1b"), "<name>.c2": max|x|, or the
    ``collect_q`` quantile of |x|."""

    def __init__(self, block, dtype, s2d, split_at: int | None = None, name: str = "",
                 int8_c1: bool = False, int8_c2: bool = False, scales: dict | None = None,
                 collect: dict | None = None, collect_q: float | None = None):
        if s2d is True:
            s2d = "dense"
        if s2d not in (False,) + S2D_FORMS:
            raise ValueError(f"unknown block form {s2d!r}")
        if (int8_c1 or int8_c2) and s2d == "pallas":
            raise ValueError("int8 not supported on the pallas block form")
        self.s2d, self.split_at, self.dtype = s2d, split_at, dtype
        self.name, self.int8_c1, self.int8_c2 = name, int8_c1, int8_c2
        self.collect, self.collect_q = collect, collect_q
        scales = scales or {}
        if int8_c1:
            self.sx1 = act_scale_from_absmax(scales["c1"])
            self.sx1b = act_scale_from_absmax(scales["c1b"]) if split_at is not None else None
        if int8_c2:
            self.sx2 = act_scale_from_absmax(scales["c2"])
        convs = {"conv1": (block.conv[0], block.conv[1]), "conv2": (block.conv[3], block.conv[4]),
                 "project_conv": (block.project[0], block.project[1])}
        folded = {}
        with torch.no_grad():
            for key, (conv, bn) in convs.items():
                scale, shift = _fold_bn(bn, conv.bias)
                folded[key] = (conv.weight.float().permute(2, 3, 1, 0) * scale, shift)
        w1, h1 = folded["conv1"]
        wp, hp = folded["project_conv"]
        w2, h2 = folded["conv2"]
        self.c1, self.cp, self.c2 = w1.shape[3], wp.shape[3], w2.shape[3]

        def parts(fn):
            """fn(w1 slice, wp slice) per input part."""
            if split_at is None:
                return fn(w1, wp)
            return (fn(w1[:, :, :split_at], wp[:, :, :split_at]),
                    fn(w1[:, :, split_at:], wp[:, :, split_at:]))

        if s2d is False or s2d == "dense":
            prep = s2d_conv_weights if s2d == "dense" else (lambda w: w)
            reps = 4 if s2d == "dense" else 1
            # conv1 and project share the input: one conv, output channels
            # [conv1 | project], each half in its own s2d channel order
            w1p = parts(lambda a, b: torch.cat([prep(a), prep(b)], 3))
            h1p = torch.cat([h1.repeat(reps), hp.repeat(reps)])
            if int8_c1:
                self.w1p, self.o1p = self._i8_c1(w1p)
                self.h1p = h1p
            else:
                self.w1p = _map(lambda w: _oihw(w.to(dtype)), w1p)
                self.h1p = h1p.to(dtype)
            if int8_c2:
                self.w2, self.o2 = _quantized(prep(w2), self.sx2)
                self.h2 = h2.repeat(reps)
            else:
                self.w2 = _oihw(prep(w2).to(dtype))
                self.h2 = h2.repeat(reps).to(dtype)
            self.n1 = reps * self.c1
        elif s2d == "pallas":
            taps = block_taps(w1, wp, w2, h1, hp, h2, split_at)
            self.k1p, self.h1p, self.k2, self.h2 = (_map(lambda x: x.to(dtype), t) for t in taps)
            # the kernel's direct taps, gathered and checked once here
            self.direct = direct_taps(self.k1p, self.h1p, self.k2, self.h2,
                                      self.c1, self.cp, self.c2)
        else:
            # one conv per x output parity, output groups (qy, [conv1 | project])
            def k1(qx):
                return parts(lambda a, b: fuse_parity_groups(s2d_conv2x2_weights_qx(a, qx),
                                                             s2d_conv2x2_weights_qx(b, qx), 2))
            k1p = (k1(0), k1(1))
            h1p = torch.cat([h1, hp]).repeat(2)
            k2 = tuple(s2d_conv2x2_weights_qx(w2, qx) for qx in range(2))
            if int8_c1:
                q = tuple(self._i8_c1(k) for k in k1p)
                self.k1p, self.o1p = tuple(w for w, _ in q), tuple(o for _, o in q)
                self.h1p = h1p
            else:
                self.k1p = tuple(_map(lambda k: _oihw(k.to(dtype)), k) for k in k1p)
                self.h1p = h1p.to(dtype)
            if int8_c2:
                q = tuple(_quantized(k, self.sx2) for k in k2)
                self.k2, self.o2 = tuple(w for w, _ in q), tuple(o for _, o in q)
                self.h2 = h2.repeat(2)
            else:
                self.k2 = tuple(_oihw(k.to(dtype)) for k in k2)
                self.h2 = h2.repeat(2).to(dtype)

    def _i8_c1(self, w1p):
        """conv1's (packed int8 weights, output scales), a pair for a split
        block (each part with its own activation scale)."""
        if self.split_at is not None:
            (wa, oa), (wb, ob) = _quantized(w1p[0], self.sx1), _quantized(w1p[1], self.sx1b)
            return (wa, wb), (oa, ob)
        return _quantized(w1p, self.sx1)

    def _in_conv(self, x, w, pad=(1, 1, 1, 1)):
        if self.split_at is not None:
            return _conv(x[0], w[0], pad) + _conv(x[1], w[1], pad)
        return _conv(x, w, pad)

    def _cstat(self, x):
        """The calibration statistic of a site: max|x|, or the collect_q
        quantile of |x|, in float32."""
        ax = x.abs().float()
        if self.collect_q is not None:
            return _quantile(ax.flatten(), self.collect_q)
        return ax.max()

    def _record_c1(self, x):
        if self.split_at is not None:
            self.collect[f"{self.name}.c1"] = self._cstat(x[0])
            self.collect[f"{self.name}.c1b"] = self._cstat(x[1])
        else:
            self.collect[f"{self.name}.c1"] = self._cstat(x)

    def _quantize_c1(self, x):
        if self.split_at is not None:
            return quantize_act(x[0], self.sx1), quantize_act(x[1], self.sx1b)
        return quantize_act(x, self.sx1)

    def __call__(self, x):
        if self.s2d == "pallas":
            return fused_s2d_block(_map(torch.Tensor.contiguous, x), self.k1p, self.h1p,
                                   self.k2, self.h2, self.c1, self.cp, self.c2,
                                   direct=self.direct)
        if self.s2d == "2x2":
            return self._call_2x2(x)
        if self.collect is not None:
            self._record_c1(x)
        if self.int8_c1:
            xq = self._quantize_c1(x)
            if self.split_at is not None:
                v = (conv_i8(xq[0], self.w1p[0], self.o1p[0])
                     + conv_i8(xq[1], self.w1p[1], self.o1p[1])) + self.h1p
            else:
                v = conv_i8(xq, self.w1p, self.o1p) + self.h1p
        else:
            v = self._in_conv(x, self.w1p) + self.h1p
        y = v[..., :self.n1].relu()
        if self.collect is not None:
            self.collect[f"{self.name}.c2"] = self._cstat(y)
        if self.int8_c2:
            y2 = conv_i8(quantize_act(y, self.sx2), self.w2, self.o2, self.h2)
        else:
            y2 = _conv(y.to(self.dtype).contiguous(), self.w2) + self.h2
        return (y2 + v[..., self.n1:]).relu().to(self.dtype)

    def _conv1_2x2(self, x, xq, qx: int):
        """conv1 and the projection of x output parity qx, float or int8."""
        if not self.int8_c1:
            return self._in_conv(x, self.k1p[qx], _PAD_QX[qx]) + self.h1p
        pad = _PAD_QX_I8[qx]
        if self.split_at is not None:
            return (conv_i8(xq[0], self.k1p[qx][0], self.o1p[qx][0], padding=pad)
                    + conv_i8(xq[1], self.k1p[qx][1], self.o1p[qx][1], padding=pad)) + self.h1p
        return conv_i8(xq, self.k1p[qx], self.o1p[qx], self.h1p, padding=pad)

    def _call_2x2(self, x):
        g = self.c1 + self.cp
        y_parts, p_parts = [None] * 4, [None] * 4
        h = None
        if self.collect is not None:
            self._record_c1(x)
        # the input quantized once; both parity convs share it
        xq = self._quantize_c1(x) if self.int8_c1 else None
        for qx in range(2):
            v = self._conv1_2x2(x, xq, qx)
            h = v.shape[1] - 1
            for qy in range(2):
                blk = v[:, qy:qy + h, :, qy * g:(qy + 1) * g]
                y_parts[2 * qy + qx] = blk[..., :self.c1].relu()
                p_parts[2 * qy + qx] = blk[..., self.c1:]
        y1 = torch.cat(y_parts, dim=-1)
        if self.collect is not None:
            self.collect[f"{self.name}.c2"] = self._cstat(y1)
        if self.int8_c2:
            y1q = quantize_act(y1, self.sx2)
        elif self.int8_c1:
            y1 = y1.to(self.dtype)
        outs = [None] * 4
        for qx in range(2):
            if self.int8_c2:
                v2 = conv_i8(y1q, self.k2[qx], self.o2[qx], self.h2, padding=_PAD_QX_I8[qx])
            else:
                v2 = _conv(y1, self.k2[qx], _PAD_QX[qx]) + self.h2
            for qy in range(2):
                q = 2 * qy + qx
                outs[q] = (v2[:, qy:qy + h, :, qy * self.c2:(qy + 1) * self.c2]
                           + p_parts[q]).relu()
        return torch.cat(outs, dim=-1).to(self.dtype)


def _pool_s2d_to_direct(x_s2d: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of the full-resolution tensor from its s2d
    form: the pool windows are the parity groups."""
    b, h, w, c4 = x_s2d.shape
    return x_s2d.reshape(b, h, w, 4, c4 // 4).amax(dim=3)


def _pool_direct(x: torch.Tensor) -> torch.Tensor:
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def pack_image_s2d(image_nhwc) -> np.ndarray:
    """Host-side packing for ``input_format="s2d"``: (B, H, W, 3) ->
    (B, H/2, W/2, 12), channel order (py, px, c), in numpy."""
    x = np.asarray(image_nhwc)
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(b, h // 2, w // 2, 4 * c))


def _stage_forms(stage_forms: dict | None) -> dict:
    """The per-stage forms: the default table with ``stage_forms`` over it,
    checked as the JAX function checks them."""
    forms = dict(DEFAULT_FORMS)
    if stage_forms:
        unknown = set(stage_forms) - set(forms)
        if unknown:
            raise ValueError(f"unknown stage_forms keys: {unknown}")
        bad = {k for k, v in stage_forms.items() if (k in DIRECT_STAGES) != (v is False)}
        if bad:
            raise ValueError(
                f"stage_forms layout mismatch for {bad}: stages {sorted(DIRECT_STAGES)} are "
                f"wired direct-resolution (form False); the others take/produce s2d tensors "
                f"(form 'dense'|'2x2'|'pallas')")
        forms.update(stage_forms)
    return forms


def build_fast_resunet_forward(model, *, dtype=torch.float32, with_mask: bool = True,
                               input_format: str = "nhwc", int8_sites=None, act_ranges=None,
                               collect_ranges: bool = False,
                               collect_quantile: float | None = None,
                               stage_forms: dict | None = None,
                               head_at_fullres: bool = False):
    """fn(image) -> (embedding, mask_logits): the eval-mode ``model``'s
    outputs 4 and 5 as NHWC tensors, the embedding in ``dtype`` and the
    logits in float32 (None without ``with_mask``).

    ``image``: a (B, H, W, 3) tensor on the model's device, H and W
    multiples of 16, or with ``input_format="s2d"`` its
    :func:`pack_image_s2d` form. ``stage_forms``: {stage: form} over the
    default table (stages "inconv", "down1".."down4", "up1".."up4"; forms
    False, "dense", "2x2", "pallas"). ``head_at_fullres``: the 1x1 embedding
    head after depth_to_space instead of per parity group (the same
    function). The weights and the BatchNorm running statistics are folded
    when this is called; later changes to the model are not seen.

    ``int8_sites`` + ``act_ranges``: run the named stage convs ("up4.c1",
    ...; :data:`INT8_DEFAULT_SITES`) in int8, ``act_ranges`` mapping each
    site to its calibrated max|activation| (:func:`calibrate_int8_ranges`;
    a split block's c1 needs its "c1b" too). ``collect_ranges=True``
    instead makes fn return (embedding, mask, ranges), ranges holding the
    statistic of every site (max|x|, or the ``collect_quantile`` quantile of
    |x|) as float32 scalar tensors."""
    int8_sites = frozenset(int8_sites or ())
    if int8_sites and not collect_ranges:
        missing = {s for s in int8_sites if s not in (act_ranges or {})}
        if missing:
            raise ValueError(f"int8 sites lack calibrated ranges: {missing}")
    ranges_out: dict = {}
    if input_format not in ("nhwc", "s2d"):
        raise ValueError(f"input_format must be 'nhwc' or 's2d', got {input_format!r}")
    if model.training:
        raise ValueError("the fast forward folds inference BatchNorm: pass the model in "
                         "eval mode")
    forms = _stage_forms(stage_forms)
    mods = dict(model.named_modules())

    def blk(stage, split_at=None):
        scales = {k[len(stage) + 1:]: v for k, v in (act_ranges or {}).items()
                  if k.startswith(stage + ".")}
        if f"{stage}.c1" in int8_sites and split_at is not None and "c1b" not in scales:
            raise ValueError(f"{stage}.c1 is split; calibrate {stage}.c1b")
        return _BlockW(mods[BLOCKS[stage]], dtype, forms[stage], split_at=split_at, name=stage,
                       int8_c1=f"{stage}.c1" in int8_sites,
                       int8_c2=f"{stage}.c2" in int8_sites, scales=scales,
                       collect=ranges_out if collect_ranges else None,
                       collect_q=collect_quantile)

    f2 = model.down2.block.conv[3].out_channels
    f3 = model.down3.block.conv[3].out_channels
    f4 = model.down4.block.conv[3].out_channels
    b_in, b_d1, b_d2, b_d3, b_d4, b_u1 = (blk(s) for s in
                                          ("inconv", "down1", "down2", "down3", "down4", "up1"))
    b_u2, b_u3, b_u4 = blk("up2", f4), blk("up3", f3), blk("up4", f2)

    with torch.no_grad():
        emb = model.outconv_emb.conv
        w_emb = emb.weight[:, :, 0, 0].t().to(dtype)  # (Cin, emd)
        b_emb = emb.bias.float() if emb.bias is not None else None
        mh = model.binary_seg
        mh_w1 = mh[0].weight[:, :, 0, 0].t().to(dtype)
        mh_scale, mh_shift = _fold_bn(mh[1], mh[0].bias)
        mh_w2 = mh[3].weight[:, :, 0, 0].t().to(dtype)
        mh_b2 = mh[3].bias.float()

    def mask_head_s2d(ys):
        """The 1x1-conv head per parity group in s2d space; only the
        2-channel logits reach full resolution."""
        b, hh, ww, c4 = ys.shape
        xg = ys.reshape(b, hh, ww, 4, c4 // 4)
        h1 = torch.einsum("bhwqi,io->bhwqo", xg, mh_w1).float()
        h1 = (h1 * mh_scale + mh_shift).relu().to(ys.dtype)
        out = torch.einsum("bhwqi,io->bhwqo", h1, mh_w2).float() + mh_b2
        return depth_to_space(out.reshape(b, hh, ww, -1))

    def forward(image: torch.Tensor):
        if input_format == "s2d":
            xs = image.to(dtype)
            h0, w0 = 2 * image.shape[1], 2 * image.shape[2]
        else:
            h0, w0 = image.shape[1], image.shape[2]
        if h0 % 16 or w0 % 16:
            raise ValueError(f"the fast forward needs H, W divisible by 16, got {h0}x{w0}")
        if input_format != "s2d":
            xs = space_to_depth(image.to(dtype))

        x1s = b_in(xs)
        x2 = _pool_s2d_to_direct(b_d1(x1s))
        x3 = _pool_s2d_to_direct(b_d2(space_to_depth(x2)))
        x4 = _pool_direct(b_d3(x3))
        x5 = _pool_direct(b_d4(x4))

        y = b_u1(_upsample_direct(x5))
        # decoder skip concats stay virtual: upsampling is linear, so
        # up(concat(y, skip)) feeds the split block as (up(y), up(skip))
        y = _pad_direct(y, x4.shape[1], x4.shape[2])
        y = b_u2((_upsample_direct(y), _upsample_direct(x4)))
        y = _pad_direct(y, x3.shape[1], x3.shape[2])
        ys = b_u3((_upsample2x_to_s2d(y, dtype), _upsample2x_to_s2d(x3, dtype)))
        y_d = _pad_direct(depth_to_space(ys), x2.shape[1], x2.shape[2])
        ys = b_u4((_upsample2x_to_s2d(y_d, dtype), _upsample2x_to_s2d(x2, dtype)))

        if head_at_fullres:
            e = depth_to_space(ys) @ w_emb
            embedding = (e.float() + b_emb if b_emb is not None else e.float()).to(dtype)
        else:
            b, hh, ww, c4 = ys.shape
            e = torch.einsum("bhwqi,io->bhwqo", ys.reshape(b, hh, ww, 4, c4 // 4), w_emb).float()
            if b_emb is not None:
                e = e + b_emb
            embedding = depth_to_space(e.to(dtype).reshape(b, hh, ww, -1))
        mask = mask_head_s2d(ys) if with_mask else None
        if collect_ranges:
            return embedding, mask, dict(ranges_out)
        return embedding, mask

    def fn(image: torch.Tensor):
        with torch.no_grad(), float32_convs():
            return forward(image)

    return fn


def calibrate_int8_ranges(model, images, *, dtype=torch.float32, with_mask: bool = True,
                          input_format: str = "nhwc", quantile: float | None = None) -> dict:
    """{site: max|activation|} for every int8 site of the fast forward of
    ``model`` (eval mode), run unquantized over ``images``, an iterable of
    batches in ``input_format`` on the model's device; feed it to
    :func:`build_fast_resunet_forward` as ``act_ranges``. ``quantile``
    takes that quantile of |x| a batch in place of the max; batches are
    aggregated by their max."""
    fwd = build_fast_resunet_forward(model, dtype=dtype, with_mask=with_mask,
                                     input_format=input_format, collect_ranges=True,
                                     collect_quantile=quantile)
    ranges: dict = {}
    for im in images:
        for k, v in fwd(im)[2].items():
            ranges[k] = max(ranges.get(k, 0.0), float(v))
    return ranges
