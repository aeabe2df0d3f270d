"""Space-to-depth (s2d) rearrangements and the exact s2d forms of a
stride-1 SAME 3x3 conv, on NHWC tensors and HWIO (3, 3, Cin, Cout) weights,
the JAX package's layouts (``pixel_embedded_affinity_tpu/ops/s2d.py``).

A SAME 3x3 conv at (H, W, C) equals a conv at (H/2, W/2, 4C) on the s2d
tensor, channel order (py, px, c), with either of two structured-sparse
kernels:

* ``s2d_conv_weights``: one dense 3x3 block-space kernel
  (3, 3, 4Cin, 4Cout), 4x the direct conv's multiply-adds;
* ``s2d_conv2x2_weights``: one 2x2 VALID conv over the 1-padded s2d
  tensor with the four output parities stacked along Cout
  (2, 2, 4Cin, 4Cout), 16/9 of the direct conv's multiply-adds; output
  parity (qy, qx) is the slice ``s2d_conv2x2_slices`` takes. Per axis, with
  P[j] = x_s2d[j - 1] (zero-padded), V[j] = K[0] P[j] + K[1] P[j + 1] and
  the output at parity q, block g, is V[g + q]; the kernel is
  K_q[b, p] = w[q + 2b + p - 1], zero where the index leaves 0..2.
* ``s2d_conv2x2_weights_qx``: the same for one x output parity, output
  channels (qy, co), for a conv whose W padding, (1, 0) for qx = 0 and
  (0, 1) for qx = 1, absorbs the x shift.

The weight transforms are gathers of the direct kernel's taps, so they
equal the JAX ones bit for bit.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (py, px, c)."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C) -> (B, 2H, 2W, C), the inverse of space_to_depth."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def _assemble(w: torch.Tensor, n_taps: int, qys, qxs, tap) -> torch.Tensor:
    """(n_taps, n_taps, 4 Cin, len(qys) len(qxs) Cout) kernel whose block
    [by, bx, (py, px, ci), (qy, qx, co)] is w[tap(qy, by, py), tap(qx, bx,
    px)], zero where tap gives None."""
    cin, cout = w.shape[2], w.shape[3]
    zero = w.new_zeros((cin, cout))
    rows = []
    for by in range(n_taps):
        cols = []
        for bx in range(n_taps):
            prow = []
            for py in range(2):
                for px in range(2):
                    qcol = []
                    for qy in qys:
                        for qx in qxs:
                            iy, ix = tap(qy, by, py), tap(qx, bx, px)
                            qcol.append(zero if iy is None or ix is None else w[iy, ix])
                    prow.append(torch.cat(qcol, dim=1))
            cols.append(torch.cat(prow, dim=0))
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def _tap2x2(q: int, b: int, p: int):
    i = q + 2 * b + p - 1
    return i if 0 <= i <= 2 else None


def s2d_conv2x2_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (2, 2, 4 Cin, 4 Cout): the per-output-parity
    2x2 kernel, input channels (py, px, ci), output (qy, qx, co)."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(w.shape)}")
    return _assemble(w, 2, (0, 1), (0, 1), _tap2x2)


def s2d_conv2x2_weights_qx(w: torch.Tensor, qx: int) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (2, 2, 4 Cin, 2 Cout): the 2x2 kernel of x
    output parity ``qx`` alone, output channels (qy, co)."""
    if tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(w.shape)}")
    return _assemble(w, 2, (0, 1), (qx,), _tap2x2)


def fuse_parity_groups(ka: torch.Tensor, kb: torch.Tensor, groups: int) -> torch.Tensor:
    """Two parity-form kernels of one input, (kh, kw, Cin, groups * ca) and
    (kh, kw, Cin, groups * cb), as one whose output channels are
    (group, [a | b]): conv1 and the projection of a residual block share
    their input and run as one conv."""
    kh, kw, ci = ka.shape[:3]
    return torch.cat([ka.reshape(kh, kw, ci, groups, -1), kb.reshape(kh, kw, ci, groups, -1)],
                     -1).reshape(kh, kw, ci, -1)


def s2d_conv2x2_slices(v: torch.Tensor, cout: int) -> torch.Tensor:
    """(B, h+1, w+1, 4 cout) result of the 2x2 VALID conv of the 1-padded
    s2d tensor -> the (B, h, w, 4 cout) s2d conv output: parity (qy, qx)
    is v[:, qy:qy+h, qx:qx+w, g*cout:(g+1)*cout], g = 2 qy + qx."""
    h, w = v.shape[1] - 1, v.shape[2] - 1
    parts = []
    for qy in range(2):
        for qx in range(2):
            g = 2 * qy + qx
            parts.append(v[:, qy:qy + h, qx:qx + w, g * cout:(g + 1) * cout])
    return torch.cat(parts, dim=-1)


def s2d_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, K, Cin, Cout) -> (3, 3, 4 Cin, 4 Cout) block-space kernel for K
    in {3, 5} (a 5-tap window still spans at most 3 blocks per axis):
    W'[by, bx, (py, px, ci), (qy, qx, co)] = w[dy + K//2, dx + K//2] with
    dy = 2 (by - 1) + py - qy, zero where |dy| or |dx| exceeds K//2."""
    kh, kw = w.shape[:2]
    if kh != kw or kh not in (3, 5):
        raise ValueError(f"expected a 3x3 or 5x5 kernel, got {tuple(w.shape)}")
    half = kh // 2

    def tap(q, b, p):
        d = 2 * (b - 1) + p - q
        return d + half if -half <= d <= half else None

    return _assemble(w, 3, (0, 1), (0, 1), tap)
