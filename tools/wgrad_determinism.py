#!/usr/bin/env python3
"""Which 2D convolutions' float32 gradients differ from run to run on the
card, and what a deterministic form of each costs.

    python3 tools/wgrad_determinism.py [--presets cvppp,bbbc039v1] [--repeats 5]

For each full-width 2D preset, one training step (float32, TF32 off, B=2
from the device-resident sampler over ``chip_smoke.py``'s synthetic data;
``chip_smoke.recorded_convs``) records every ``Conv2d``'s input and output
gradient. Then, for each conv, its weight gradient alone
(``aten.convolution_backward``, the op autograd runs for ``F.conv2d``) is
computed ``--repeats`` times with cuDNN's default algorithm choice and
compared bit for bit (its input gradient too), and timed by CUDA events
(median of 20, L2 not flushed) three ways: cuDNN's default algorithm,
cuDNN under ``torch.backends.cudnn.deterministic``, and CWg, the shipped
kernel of ``csrc/conv_grad.cu`` (``ops/conv_grad_cuda.conv_wgrad``), whose
repeats are compared bit for bit too; CXg, the input gradient's kernel,
beside cuDNN's default input gradient. One JSON line a conv, then a
summary a preset: the convs whose default gradients varied, and the sum
over them and over every conv of each form's ms. Ends with the card's name
and power limit. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def events_ms(fn, n: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def backward(conv, x, dy, mask):
    import torch

    return torch.ops.aten.convolution_backward(
        dy, x, conv.weight, None, list(conv.stride), list(conv.padding), list(conv.dilation),
        False, [0, 0], conv.groups, mask)


def wgrad(conv, x, dy):
    return backward(conv, x, dy, [False, True, False])[1]


def dgrad(conv, x, dy):
    return backward(conv, x, dy, [True, False, False])[0]


def varies(fn, repeats: int) -> bool:
    import torch

    first = fn()
    return any(not torch.equal(first, fn()) for _ in range(repeats - 1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgrad_determinism: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", default="cvppp,bbbc039v1")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad
    from tools.step_determinism import preset_data

    torch.backends.cudnn.allow_tf32 = False
    for preset in args.presets.split(","):
        convs = smoke.recorded_convs(preset, preset_data(preset))
        rows = []
        for name, conv, x, dy, need_x in convs:
            wt = conv.weight.detach()
            row = {"preset": preset, "conv": name, "x": list(x.shape),
                   "weight": list(conv.weight.shape), "stride": list(conv.stride),
                   "default_varied": varies(lambda: wgrad(conv, x, dy), args.repeats),
                   "dgrad_varied": varies(lambda: dgrad(conv, x, dy), args.repeats),
                   "default_ms": events_ms(lambda: wgrad(conv, x, dy)),
                   "dgrad_ms": events_ms(lambda: dgrad(conv, x, dy))}
            torch.backends.cudnn.deterministic = True
            try:
                row["deterministic_varied"] = varies(lambda: wgrad(conv, x, dy), args.repeats)
                row["deterministic_ms"] = events_ms(lambda: wgrad(conv, x, dy))
            finally:
                torch.backends.cudnn.deterministic = False
            if conv._kernel_grad:
                row["cwg_varied"] = varies(lambda: conv_wgrad(x, dy, wt.shape), args.repeats)
                row["cwg_ms"] = events_ms(lambda: conv_wgrad(x, dy, wt.shape))
                if need_x:
                    row["cxg_varied"] = varies(lambda: conv_dgrad(dy, wt), args.repeats)
                    row["cxg_ms"] = events_ms(lambda: conv_dgrad(dy, wt))
            rows.append(row)
            print(json.dumps(row))
        bad = [r for r in rows if r["default_varied"]]
        print(json.dumps({
            "preset": preset, "convs": len(rows),
            "default_varied": [r["conv"] for r in bad],
            "dgrad_varied": [r["conv"] for r in rows if r["dgrad_varied"]],
            "cwg_varied": [r["conv"] for r in rows if r.get("cwg_varied")],
            "cxg_varied": [r["conv"] for r in rows if r.get("cxg_varied")],
            "default_ms_all": sum(r["default_ms"] for r in rows),
            "deterministic_ms_all": sum(r["deterministic_ms"] for r in rows),
            "cwg_ms_all": sum(r.get("cwg_ms", 0.0) for r in rows),
            "default_ms_varied": sum(r["default_ms"] for r in bad),
            "deterministic_ms_varied": sum(r["deterministic_ms"] for r in bad),
            "cwg_ms_varied": sum(r.get("cwg_ms", 0.0) for r in bad),
            "dgrad_ms_all": sum(r["dgrad_ms"] for r in rows if "cxg_ms" in r),
            "cxg_ms_all": sum(r.get("cxg_ms", 0.0) for r in rows)}))
        del convs
        torch.cuda.empty_cache()
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
