#!/usr/bin/env python3
"""Where one CVPPP train step's float32 gradients part from float64.

    python3 tools/grad_precision.py            # one CUDA card, full width
    python3 tools/grad_precision.py --small    # the CPU, filters (4, 6, 8, 12, 16), 64x64

The cvppp preset (filters 16..256, emd 16), B=2, on chip_smoke.py's 544x544
synthetic leaves, through the plain loss path (``use_pallas=False``;
chip_smoke.py shows the kernels add no error to it). One step's parameter
gradients in float32 (convolutions with TF32 off) are held against the same
step in float64, per tensor, as max |g32 - g64| / max |g64|:

  default   cuDNN, as the trainer runs;
  no-cudnn  cuDNN disabled (PyTorch's own convolutions);
  replay    the float64 run's discrete choices replayed in float32: each
            ReLU's sign pattern and each max-pool's argmax, in the student
            and the teacher forward.

It counts the choices float32 makes differently (ReLU signs, pool argmaxes),
and, for every convolution and BatchNorm of the student forward, prints the
float32 run's error in the module's input and in the gradient that reaches
its output, and the module's own rounding: its weight gradient (convolution)
or its input gradient (BatchNorm) recomputed alone in float32 from the
float64 run's input and output gradient. Once at the weights drawn from the
preset's seed, once after chip_smoke.py's 8 training steps.
"""

from __future__ import annotations

import argparse
import copy
import os
import re
import shutil
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SMALL_FILTERS = (4, 6, 8, 12, 16)
# the conv biases in front of train-mode BatchNorm: true gradient 0
BIAS_BEFORE_BN = re.compile(r"(conv\.[03]|project\.0)\.bias$")


class Choices:
    """Each ReLU's sign pattern and each max-pool's argmax in call order:
    recorded (``mode="record"``), replayed (``"replay"``) or neither
    (``"off"``). ``stack`` holds the modules running, for labels."""

    def __init__(self):
        self.mode, self.log, self.i, self.stack = "off", [], 0, []

    def _label(self, kind):
        return f"{self.stack[-1] if self.stack and self.stack[-1] else 'model'} {kind}"

    def _replayed(self):
        v = self.log[self.i][1]
        self.i += 1
        return v

    def relu(self, x, inplace=False):
        import torch

        if self.mode == "replay":
            return x * self._replayed().to(x.dtype)
        if self.mode == "record":
            self.log.append((self._label("relu"), x.detach() > 0))
        return torch.relu(x)

    def max_pool2d(self, x, k):
        import torch.nn.functional as F

        if self.mode == "replay":
            idx = self._replayed()
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        y, idx = F.max_pool2d(x, k, return_indices=True)
        if self.mode == "record":
            self.log.append((self._label("max_pool"), idx))
        return y


class _FunctionalProxy:
    """``torch.nn.functional`` with relu and max_pool2d routed to Choices."""

    def __init__(self, choices):
        self.choices = choices

    def __getattr__(self, name):
        import torch.nn.functional as F

        if name in ("relu", "max_pool2d"):
            return getattr(self.choices, name)
        return getattr(F, name)


def instrument(model, choices):
    """The model's ReLU modules routed to ``choices``, its module stack
    tracked, and the student forward's input and output gradient of every
    Conv2d and BatchNorm2d captured; returns that store."""
    import torch
    from torch import nn

    class Relu(nn.Module):
        def forward(self, x):
            return choices.relu(x)

    for name, mod in list(model.named_modules()):
        for child_name, child in list(mod.named_children()):
            if isinstance(child, nn.ReLU):
                setattr(mod, child_name, Relu())
    def leave(m, inp, out):
        choices.stack.pop()  # returns None: the output stays

    store: dict = {}
    for name, mod in model.named_modules():
        mod.register_forward_pre_hook(lambda m, i, name=name: choices.stack.append(name))
        mod.register_forward_hook(leave)
        if isinstance(mod, (nn.Conv2d, nn.BatchNorm2d)):
            def keep_x(m, inp, out, name=name):
                if torch.is_grad_enabled():  # the student pass; the teacher's is no_grad
                    store.setdefault(name, {})["x"] = inp[0].detach()

            def keep_dy(m, gin, gout, name=name):
                store.setdefault(name, {})["dy"] = gout[0].detach()
            mod.register_forward_hook(keep_x)
            mod.register_full_backward_hook(keep_dy)
    return store


def rel(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    b = b.double()
    return ((a.double() - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()


def local_error(mod, x64, dy64) -> float:
    """The module's own float32 rounding: its weight gradient (Conv2d) or
    input gradient (train-mode BatchNorm2d) from the float64 run's input and
    output gradient, computed in float32 against float64."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    def grad(dtype):
        x, dy = x64.to(dtype), dy64.to(dtype)
        if isinstance(mod, nn.Conv2d):
            return torch.nn.grad.conv2d_weight(x, mod.weight.shape, dy, padding=mod.padding)
        x = x.requires_grad_()
        y = F.batch_norm(x, None, None, mod.weight.detach().to(dtype),
                         mod.bias.detach().to(dtype), True, 0.0, mod.eps)
        return torch.autograd.grad(y, x, dy)[0]

    return rel(grad(torch.float32), grad(torch.float64))


def run(template, step_fn, batch, choices, dtype, mode, log=None, cudnn=True):
    """One step's gradients of a copy of ``template`` in ``dtype``; returns
    (gradients by name, captured store, choices log)."""
    import torch

    from pixel_embedded_affinity_torch.models import resunet2d

    model = copy.deepcopy(template).to(dtype)
    store = instrument(model, choices)
    if dtype == torch.float64:
        batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    choices.mode, choices.log, choices.i, choices.stack = mode, log or [], 0, []
    saved_f = resunet2d.F
    resunet2d.F = _FunctionalProxy(choices)
    try:
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            step_fn.grads(model, batch)
    finally:
        resunet2d.F = saved_f
        choices.mode = "off"
    if log is not None:
        assert choices.i == len(log), "replay out of step with the recorded run"
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return grads, store, choices.log, model


def per_tensor(grads, ref):
    return {n: rel(grads[n], r) for n, r in ref.items() if not BIAS_BEFORE_BN.search(n)}


def report(label, step_fn, template, batch, device):
    import torch

    choices = Choices()
    g64, s64, log64, m64 = run(template, step_fn, batch, choices, torch.float64, "record")
    g32, s32, log32, _ = run(template, step_fn, batch, choices, torch.float32, "record")
    variants = {"default": per_tensor(g32, g64)}
    if device == "cuda":
        gnc, _, _, _ = run(template, step_fn, batch, choices, torch.float32, "off",
                           cudnn=False)
        variants["no-cudnn"] = per_tensor(gnc, g64)
    grp, _, _, _ = run(template, step_fn, batch, choices, torch.float32, "replay", log=log64)
    variants["replay"] = per_tensor(grp, g64)

    print(f"[{label}] float32 vs float64 parameter gradients, max |g32 - g64| / max |g64| "
          f"per tensor ({len(variants['default'])} tensors; the biases in front of "
          f"BatchNorm left out):")
    for name, errs in variants.items():
        worst = sorted(errs.items(), key=lambda t: -t[1])[:4]
        print(f"[{label}]   {name:9s} median {np.median(list(errs.values())):.3e}, worst "
              + ", ".join(f"{n} {e:.3e}" for n, e in worst))

    flips = []
    for (where, a), (_, b) in zip(log32, log64):
        n = int((a != b).sum().item())
        if n:
            flips.append((where, n, a.numel()))
    total = sum(n for _, n, _ in flips)
    print(f"[{label}] choices float32 makes differently: {total} in {len(flips)} of "
          f"{len(log64)} ReLU / max-pool calls (student and teacher forward)")
    for where, n, size in sorted(flips, key=lambda t: -t[1])[:8]:
        print(f"[{label}]   {where}: {n} of {size}")

    print(f"[{label}] per module of the student forward: input error, output-gradient "
          f"error (float32 run vs float64), and the module's own float32 rounding")
    mods = dict(m64.named_modules())
    worst_local = (None, 0.0)
    for name, rec64 in s64.items():
        if "dy" not in rec64:  # the mask head: off the cvppp loss
            continue
        rec32 = s32[name]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            loc = local_error(mods[name], rec64["x"], rec64["dy"])
        if loc > worst_local[1]:
            worst_local = (name, loc)
        print(f"[{label}]   {name:28s} {tuple(rec64['x'].shape[1:])!s:18s} x {rel(rec32['x'], rec64['x']):.1e}"
              f"  dy {rel(rec32['dy'], rec64['dy']):.1e}  own {loc:.1e}")
    print(f"[{label}] largest own rounding: {worst_local[0]} {worst_local[1]:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help=f"a quick check on the CPU: filters {SMALL_FILTERS}, 64x64 images")
    args = ap.parse_args()
    device = "cpu" if args.small else "cuda"

    import torch

    # the first convolution's input needs no gradient: its hook still fires
    warnings.filterwarnings("ignore", message="Full backward hook is firing")
    if device == "cuda" and not torch.cuda.is_available():
        print("grad_precision: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TRAIN_STEPS, LeafSet, card_line, synthetic_leaves
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.provider import collate, to_device
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.train import TrainStep2D, init_state, train

    out = os.path.join(REPO, "build", "grad_precision")
    shutil.rmtree(out, ignore_errors=True)
    over = {"train": {"use_pallas": False, "num_workers": 1, "display_freq": 1,
                      "save_freq": 10 ** 6, "if_valid": False},
            "data": {"device_resident": False},  # the LeafSet host samples below
            "save_path": os.path.join(out, "models")}
    side = 544
    if args.small:
        over["model"] = {"filters": SMALL_FILTERS}
        side = 64
    cfg = load_config("cvppp", over)
    # the CVPPP padding takes 530x500 to 544x544 and 50x20 to 64x64
    samples = synthetic_leaves(4, *((530, 500) if side == 544 else (50, 20)), 0)
    data = LeafSet([{"image": s["image"], "seg": s["seg"]} for s in samples])
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    step_fn = TrainStep2D(offsets, use_pallas=False, device_ema=False)
    ema_step = TrainStep2D(offsets, ema_seed=cfg.train.random_seed)
    print(f"[setup] cvppp filters {cfg.model.filters} emd {cfg.model.emd}, B=2, "
          f"{side}x{side}, plain loss path, {device}"
          + (f", {card_line()}" if device == "cuda" else ""))

    rng = np.random.default_rng(0)
    batch = ema_step.ema_batch(to_device(collate([data.sample(rng) for _ in range(2)]),
                                         device), 0)
    state = init_state(cfg, device)
    report("init", step_fn, state.model, batch, device)
    state, _ = train(cfg, max_iters=TRAIN_STEPS, data_override=(data, []),
                     device=device)
    report(f"step {TRAIN_STEPS}", step_fn, state.model, batch, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
