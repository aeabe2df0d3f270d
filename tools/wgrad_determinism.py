#!/usr/bin/env python3
"""Which 2D convolutions' float32 weight gradients differ from run to run
on the card, and what a deterministic form of each costs.

    python3 tools/wgrad_determinism.py [--presets cvppp,bbbc039v1] [--repeats 5]

For each full-width 2D preset, one training step (float32, TF32 off, B=2
from the device-resident sampler over ``chip_smoke.py``'s synthetic data)
records every ``Conv2d``'s input and output gradient. Then, for each conv,
its weight gradient alone (``aten.convolution_backward``, the op autograd
calls) is computed ``--repeats`` times with cuDNN's default algorithm
choice and compared bit for bit (its input gradient too), and timed by CUDA events (median of 20,
L2 not flushed) three ways: cuDNN's default algorithm, cuDNN under
``torch.backends.cudnn.deterministic``, and for a 1x1 conv the product of
``models/common.py``'s ``_Conv1x1``. One JSON line a conv, then a summary
a preset: the convs whose default weight gradient varied, and the sum over
them and over every conv of each form's ms. Ends with the card's name and
power limit. Exits 1 without a card.
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


def recorded_step(preset: str, data):
    """One step's (name, conv, input, output gradient) for every Conv2d."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = load_config(preset)
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg)
    batch = step.ema_batch(resident_sampler(cfg, data, torch.device("cuda"))(0), 0)
    seen: dict = {}
    hooks = []
    for name, m in state.model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            def fwd(mod, inp, out, name=name):
                if torch.is_grad_enabled():
                    seen.setdefault(name, {"conv": mod})["x"] = inp[0].detach()

            def bwd(mod, gin, gout, name=name):
                seen[name]["dy"] = gout[0].detach()

            hooks += [m.register_forward_hook(fwd), m.register_full_backward_hook(bwd)]
    step.grads(state.model, batch)
    for h in hooks:
        h.remove()
    return [(n, r["conv"], r["x"], r["dy"]) for n, r in seen.items() if "dy" in r]


def wgrad(conv, x, dy):
    import torch

    return torch.ops.aten.convolution_backward(
        dy, x, conv.weight, None, list(conv.stride), list(conv.padding), list(conv.dilation),
        False, [0, 0], conv.groups, [False, True, False])[1]


def dgrad(conv, x, dy):
    import torch

    return torch.ops.aten.convolution_backward(
        dy, x, conv.weight, None, list(conv.stride), list(conv.padding), list(conv.dilation),
        False, [0, 0], conv.groups, [True, False, False])[0]


def product(conv, x, dy):
    import torch

    n, c_out, c_in = dy.shape[0], conv.weight.shape[0], conv.weight.shape[1]
    dw = torch.matmul(dy.reshape(n, c_out, -1), x.reshape(n, c_in, -1).transpose(1, 2))
    return dw.sum(0).view_as(conv.weight)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgrad_determinism: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", default="cvppp,bbbc039v1")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    from tools.step_determinism import preset_data

    torch.backends.cudnn.allow_tf32 = False
    for preset in args.presets.split(","):
        convs = recorded_step(preset, preset_data(preset))
        rows = []
        for name, conv, x, dy in convs:
            first = wgrad(conv, x, dy)
            varied = any(not torch.equal(first, wgrad(conv, x, dy))
                         for _ in range(args.repeats - 1))
            default_ms = events_ms(lambda: wgrad(conv, x, dy))
            dx = dgrad(conv, x, dy)
            dx_varied = any(not torch.equal(dx, dgrad(conv, x, dy))
                            for _ in range(args.repeats - 1))
            torch.backends.cudnn.deterministic = True
            try:
                det = wgrad(conv, x, dy)
                det_varied = any(not torch.equal(det, wgrad(conv, x, dy))
                                 for _ in range(args.repeats - 1))
                det_ms = events_ms(lambda: wgrad(conv, x, dy))
            finally:
                torch.backends.cudnn.deterministic = False
            row = {"preset": preset, "conv": name, "x": list(x.shape),
                   "weight": list(conv.weight.shape), "stride": list(conv.stride),
                   "default_varied": varied, "deterministic_varied": det_varied,
                   "dgrad_varied": dx_varied,
                   "default_ms": default_ms, "deterministic_ms": det_ms}
            if conv.kernel_size == (1, 1) and conv.stride == (1, 1):
                row["product_ms"] = events_ms(lambda: product(conv, x, dy))
                row["product_err"] = float((product(conv, x, dy) - first).abs().max()
                                           / first.abs().max())
            rows.append(row)
            print(json.dumps(row))
        bad = [r for r in rows if r["default_varied"]]
        print(json.dumps({
            "preset": preset, "convs": len(rows),
            "default_varied": [r["conv"] for r in bad],
            "dgrad_varied": [r["conv"] for r in rows if r["dgrad_varied"]],
            "default_ms_all": sum(r["default_ms"] for r in rows),
            "deterministic_ms_all": sum(r["deterministic_ms"] for r in rows),
            "default_ms_varied": sum(r["default_ms"] for r in bad),
            "deterministic_ms_varied": sum(r["deterministic_ms"] for r in bad),
            "product_ms_1x1": sum(r.get("product_ms", 0.0) for r in rows),
            "default_ms_1x1": sum(r["default_ms"] for r in rows if "product_ms" in r),
            "deterministic_ms_1x1": sum(r["deterministic_ms"] for r in rows
                                        if "product_ms" in r)}))
        del convs
        torch.cuda.empty_cache()
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
