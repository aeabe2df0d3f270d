"""Analytic FLOP and HBM-traffic counts for the roofline (the JAX
package's ``utils/flops.py``), with the H100's peaks.

The reference counts conv MACs with ptflops in its models' __main__
blocks (scripts_cvppp/model/unet2d_residual.py:356-381); this module does
the same analytically, so each measured time can carry a share of the
card's peak. The counts are the JAX package's integers:

* FLOPs are 2x the conv MACs of the reference architecture, the useful
  work, however an implementation restructures the convs. Bias adds,
  BatchNorm, activations, pooling and upsampling are O(activations) and
  left out (<1% of the conv FLOPs at these shapes).
* ``hbm_bytes`` is an analytic floor on HBM traffic: parameters read once,
  the input read once, and every layer's output written and read once at
  its logical size in the compute dtype.
* Peaks: the card's dense rates and HBM bandwidth from its data sheet,
  keyed by ``torch.cuda.get_device_name``. A card may run below its
  maximum power limit (``nvidia-smi``'s ``power.limit``), and then below
  these rates.
"""

from __future__ import annotations

# torch.cuda.get_device_name -> peaks. NVIDIA H100 SXM5 data sheet, dense
# (no sparsity), at its 700 W maximum power limit, as the card reports
# itself: "NVIDIA H100 80GB HBM3" (nvidia-smi: "NVIDIA H100 80GB HBM3,
# 700.00 W"). float32 is the rate outside the tensor cores.
H100_PEAKS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12}
CHIP_PEAKS = {"NVIDIA H100 80GB HBM3": H100_PEAKS}


def chip_peaks(device_kind: str) -> dict | None:
    """The peaks of the card named ``device_kind`` (FLOP/s or OP/s by
    ``"bf16"``, ``"int8"``, ``"tf32"``, ``"f32"``; HBM bytes/s by
    ``"hbm"``), or None for a card not in the table (callers then leave
    the share out rather than report against a guessed roof)."""
    peaks = CHIP_PEAKS.get(device_kind)
    return None if peaks is None else dict(peaks)


class _Acc:
    def __init__(self, act_bytes_per_el: int):
        self.macs = 0
        self.act_bytes = 0
        self.params = 0
        self._el = act_bytes_per_el

    def conv(self, spatial, kvol, cin, cout):
        """One conv: kvol = kernel volume (e.g. 9 for 3x3, 27 for 3x3x3).
        spatial = number of output positions (already includes batch)."""
        self.macs += spatial * kvol * cin * cout
        self.params += kvol * cin * cout
        # output written once + read once by the next consumer
        self.act_bytes += 2 * spatial * cout * self._el


def resunet2d_flops(B: int, H: int, W: int, in_ch: int = 3,
                    nfeatures=(16, 32, 64, 128, 256), emd: int = 16,
                    mask_classes: int = 2, act_bytes: int = 2):
    """(flops, hbm_bytes_floor, params) for ResidualUNet2DDeep
    (``models.ResidualUNet2DDeep``; reference scripts_cvppp/model/
    unet2d_residual.py:279-353). act_bytes: compute dtype size (2=bf16)."""
    f = list(nfeatures)
    a = _Acc(act_bytes)

    def block(h, w, cin, cout):
        a.conv(B * h * w, 9, cin, cout)   # conv1
        a.conv(B * h * w, 9, cout, cout)  # conv2
        a.conv(B * h * w, 9, cin, cout)   # projection
    # encoder: Down = block at the INCOMING resolution, then maxpool
    block(H, W, in_ch, f[0])              # inconv
    block(H, W, f[0], f[1])               # down1
    block(H // 2, W // 2, f[1], f[2])     # down2
    block(H // 4, W // 4, f[2], f[3])     # down3
    block(H // 8, W // 8, f[3], f[4])     # down4 (pool -> /16)
    a.conv(B * (H // 16) * (W // 16), 1, f[4], emd)   # outconv1
    block(H // 8, W // 8, f[4], f[4])     # up1 (after 2x upsample)
    a.conv(B * (H // 8) * (W // 8), 1, f[4], emd)     # outconv2
    block(H // 4, W // 4, f[4] + f[3], f[3])          # up2 (concat skip)
    a.conv(B * (H // 4) * (W // 4), 1, f[3], emd)     # outconv3
    block(H // 2, W // 2, f[3] + f[2], f[2])          # up3
    a.conv(B * (H // 2) * (W // 2), 1, f[2], emd)     # outconv4
    block(H, W, f[2] + f[1], f[1])        # up4
    a.conv(B * H * W, 1, f[1], emd)       # outconv_emb
    a.conv(B * H * W, 1, f[1], f[1])      # mask head conv1
    a.conv(B * H * W, 1, f[1], mask_classes)          # mask head conv2
    bytes_floor = (a.params * act_bytes           # weights read once
                   + B * H * W * in_ch * act_bytes  # input
                   + a.act_bytes)
    return 2 * a.macs, bytes_floor, a.params


def emb2aff2d_flops(B: int, H: int, W: int, n_offsets: int = 10,
                    emd: int = 16):
    """Fused embedding->affinity: normalize (~3 ops/el) + per-offset
    channel dot (emd MACs/px). Output affinities are f32."""
    flops = 2 * B * H * W * emd * n_offsets + 3 * B * H * W * emd
    out_bytes = B * H * W * n_offsets * 4
    return flops, out_bytes


def unet3d_pni_flops(B: int, D: int, H: int, W: int, in_ch: int = 1,
                     filters=(28, 36, 48, 64, 80), emd: int = 16,
                     act_bytes: int = 2):
    """(flops, hbm_bytes_floor, params) for UNetPNIEmbeddingDeep
    (``models.UNetPNIEmbeddingDeep``; reference scripts_ac3ac4/model/
    model_superhuman.py:336-492). Downsampling is xy-only."""
    f2 = [filters[0]] + list(filters)
    a = _Acc(act_bytes)

    def rb(d, h, w, cin, cout):
        sp = B * d * h * w
        a.conv(sp, 9, cin, cout)     # 1x3x3 conv_in
        a.conv(sp, 27, cout, cout)   # 3x3x3 conv1
        a.conv(sp, 27, cout, cout)   # 3x3x3 conv2
    a.conv(B * D * H * W, 25, in_ch, f2[0])          # embed_in 1x5x5
    rb(D, H, W, f2[0], f2[1])                        # conv0
    rb(D, H // 2, W // 2, f2[1], f2[2])              # conv1
    rb(D, H // 4, W // 4, f2[2], f2[3])              # conv2
    rb(D, H // 8, W // 8, f2[3], f2[4])              # conv3
    rb(D, H // 16, W // 16, f2[4], f2[5])            # center
    a.conv(B * D * (H // 8) * (W // 8), 1, f2[5], f2[4])   # up0
    rb(D, H // 8, W // 8, f2[4], f2[4])              # conv4
    a.conv(B * D * (H // 4) * (W // 4), 1, f2[4], f2[3])   # up1
    rb(D, H // 4, W // 4, f2[3], f2[3])              # conv5
    a.conv(B * D * (H // 2) * (W // 2), 1, f2[3], f2[2])   # up2
    rb(D, H // 2, W // 2, f2[2], f2[2])              # conv6
    a.conv(B * D * H * W, 1, f2[2], f2[1])           # up3
    rb(D, H, W, f2[1], f2[1])                        # conv7
    a.conv(B * D * H * W, 25, f2[1], f2[0])          # embed_out 1x5x5
    # heads: full-res + 4 deep-supervision scales
    a.conv(B * D * H * W, 1, f2[0], emd)
    a.conv(B * D * (H // 16) * (W // 16), 1, f2[5], emd)
    a.conv(B * D * (H // 8) * (W // 8), 1, f2[4], emd)
    a.conv(B * D * (H // 4) * (W // 4), 1, f2[3], emd)
    a.conv(B * D * (H // 2) * (W // 2), 1, f2[2], emd)
    bytes_floor = (a.params * act_bytes
                   + B * D * H * W * in_ch * act_bytes
                   + a.act_bytes)
    return 2 * a.macs, bytes_floor, a.params


def roofline_fields(flops: float, hbm_bytes: float, dt_seconds: float,
                    device_kind: str, dtype: str = "bf16") -> dict:
    """{'mfu_pct': ..., 'hbm_bw_pct': ...} for a measured time, or {} if the
    card's peaks are unknown. ``dtype`` picks the compute roof: "bf16",
    "int8", "tf32" or "f32" (float32 on the CUDA cores; the JAX package
    reports float32 against the bf16 roof, which on this card would hide
    a factor of 15)."""
    peaks = chip_peaks(device_kind)
    if peaks is None or dt_seconds <= 0:
        return {}
    if dtype not in peaks or dtype == "hbm":
        raise ValueError(f"dtype {dtype!r}: expected bf16, int8, tf32 or f32")
    return {
        "mfu_pct": round(100.0 * flops / dt_seconds / peaks[dtype], 2),
        "hbm_bw_pct": round(100.0 * hbm_bytes / dt_seconds / peaks["hbm"], 2),
    }
