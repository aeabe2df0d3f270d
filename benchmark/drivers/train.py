"""The training driver: a closed loop of ``train()``'s calls on the program.

Set-up builds one training object as ``train()`` builds it, from the
program's public pieces (``train/loop.py``: ``init_state``,
``make_train_step``, ``resident_sampler``, and ``GraphedStep`` for
``steps_per_call`` S > 1), loads the benchmark's weights drawn from the seed,
and drives it through its first call of S steps: the warm-up step, the
capture and the first replays. The window then runs whole calls, each as
``train()``'s loop body runs it (each step's batch drawn on the card, the step
run, its loss kept on the card; the losses fetched at the display points),
until ``--seconds`` have passed; it ends at the synchronise after the last
call. A traced run profiles ``trace_calls`` calls in place of the window.

Correctness: the plain reference follows the first ``check_steps`` steps from
the same weights on the same batches and EMA views, which it takes as the
program's sampler and EMA view drew them (the reference cannot draw the
card's random numbers); the sampler's batches are checked by themselves
against what the synthetic data looks like, and the teacher's view against
the student's image. Compared: each step's loss, each leaf's first gradient as
AMSGrad got it (its first moment after step 1, over 1 - b1) and each leaf's
change after the steps, by the gap between the program's norm and the
reference's over the larger of the reference leaf's and the median leaf's.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import flops as yardstick
from ..synth import alignment_gap
from ..trace import capture
from ..reference import amsgrad, precision, steps

B1 = 0.9


class Loop:
    """``train()``'s loop body over a runner: calls of S steps, the losses
    fetched at display points."""

    def __init__(self, runner, next_batch, opt, steps_per_call: int, display_freq: int):
        self.runner, self.next_batch, self.opt = runner, next_batch, opt
        self.s = steps_per_call
        self.display = -(-display_freq // self.s) * self.s  # rounded up to S, as train()
        self.it = 0
        self.pending: list = []
        self.losses: list = []

    def step(self):
        with record_function("bench.draw"):
            batch = self.next_batch(self.it)
        self.opt.lr(self.opt.param_groups[0])
        with record_function("bench.step"):
            _, metrics = self.runner(batch)
        self.it += 1
        self.pending.append(metrics["loss"])

    def after_call(self):
        if self.it % self.display < self.s or self.it <= self.s:
            self.drain()

    def call(self):
        for _ in range(self.s):
            self.step()
        self.after_call()

    def drain(self):
        if self.pending:
            with record_function("bench.fetch"):
                self.losses += torch.stack(self.pending).cpu().tolist()
            self.pending.clear()


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref|, median leaf |ref|)."""
    keys = list(ref) if keys is None else list(keys)
    floor = float(np.median([ref[k] for k in ref])) if ref else 0.0
    gaps = [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30) for k in keys]
    return max(gaps) if gaps else 0.0


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, from two snapshots of {"losses", "grad1",
    "change"} (per-leaf norms). The change leaves out leaves whose reference
    first gradient is under a thousandth of the median leaf's (round-off
    moves them under AMSGrad)."""
    n = len(ref["losses"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:n], ref["losses"]))
    g = ref["grad1"]
    med = float(np.median(list(g.values())))
    moving = [k for k in g if g[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap, "grad1_gap": leaf_gap(prog["grad1"], g),
            "change_gap": leaf_gap(prog["change"], ref["change"], moving)}


def _first_moment(opt, names: dict) -> dict:
    out = {}
    for p, name in names.items():
        st = opt.state.get(p)
        out[name] = st["mu"] / (1 - B1) if st else torch.zeros_like(p)
    return out


def teacher_view_gap(batches, is_3d: bool, tol: float = 1e-4) -> float:
    """The largest share, per sample and channel (2D) or per section (3D), of
    neighbouring voxels in the student's image's value order at which the
    teacher's view, put back by its rule, falls by more than ``tol``. The
    view's intensity jitter is monotone, so a view of this image put back by
    the right rule falls only at its cutout (3D: its zeroed voxels, left
    out; 2D: its filled squares); a view of another image, or one put back by
    a wrong rule, falls at about half of them."""
    from ..reference.ops import unflip_2d, unflip_3d

    worst = 0.0
    for b in batches:
        img, ema = b["image"], b["ema_image"]
        back = unflip_3d(ema, b["rules"]) if is_3d else unflip_2d(ema, b["rules"])
        if is_3d:
            a, v = img[..., 0].flatten(2), back[..., 0].flatten(2)  # (B, D, HW)
        else:
            a, v = img.permute(0, 3, 1, 2).flatten(2), back.permute(0, 3, 1, 2).flatten(2)
        order = torch.sort(a, dim=-1, stable=True).indices
        vs = torch.gather(v, -1, order)
        kept = (vs[..., 1:] != 0) & (vs[..., :-1] != 0)
        if not is_3d:
            kept = torch.ones_like(kept)
        falls = (vs[..., 1:] < vs[..., :-1] - tol) & kept
        share = falls.sum(-1).double() / kept.sum(-1).clamp(min=1).double()
        worst = max(worst, float(share.max()))
    return worst


def make_data(ctx, cfg):
    """The training arrays as the program's loader gives them, made on the
    card from the seed."""
    from pixel_embedded_affinity_torch.data import device_data as dd

    from ..synth import em_volume, leaf_stack

    synth = ctx.cell.config["synth"]
    if synth["kind"] == "leaves":
        images, labels = leaf_stack(synth["images"], synth["height"], synth["width"],
                                    synth["pad"], ctx.seed, ctx.device)
        return images.cpu().numpy(), labels.cpu().numpy()
    raw, label = em_volume(tuple(synth["shape"]), tuple(synth["cell"]), ctx.seed, 2, ctx.device)
    return dd.load_ac3ac4_arrays("", train_split=cfg.data.train_split, if_dilate=False,
                                 crop_z=cfg.data.crop_size[0],
                                 arrays=(raw.cpu().numpy(), label.cpu().numpy()))


def conv2d_shapes(model, input_shape, no_gradient=()) -> list:
    """[(n, cin, h, w, cout, kh, kw, needs dx)] of every 2D conv of a forward
    at ``input_shape`` (traced on the meta device), without the convs under
    ``no_gradient`` prefixes; a conv whose input is the image needs no dx."""
    shapes, hooks = [], []
    x = torch.empty(input_shape, device="meta")
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d) and not name.startswith(tuple(no_gradient)):
            def hook(m, inp, out, name=name):
                n, cin, h, w = inp[0].shape
                shapes.append((n, cin, h, w, m.out_channels, *m.kernel_size, inp[0] is not x))
            hooks.append(mod.register_forward_hook(hook))
    try:
        model.to("meta")(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def reference_snapshot(ctx, cfg, batches, weights, tf32: bool) -> dict:
    """The plain reference's losses, first gradients and changes over the
    batches, from ``weights``."""
    mod = ctx.reference_module()
    is_3d = cfg.model.arch == "unet_pni_deep"
    with precision(tf32):
        model = mod.build(ctx.cell.config["model"]).to(ctx.device)
        model.load_state_dict(weights)
        model.train()
        params = dict(model.named_parameters())
        opt = amsgrad.AMSGrad(params.values(), lr=cfg.train.base_lr, eps=0.01,
                              weight_decay=cfg.train.weight_decay or 0.0)
        losses, grad1 = [], None
        for k, batch in enumerate(batches):
            model.zero_grad(set_to_none=True)
            if is_3d:
                loss = steps.loss_3d(model, batch, cfg.train.affs0_weight)
            else:
                loss = steps.loss_2d(model, batch, cfg.data.shifts, cfg.data.neighbor,
                                     cfg.train.affs0_weight)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if k == 0:
                grad1 = leaf_norms({n: (opt.state[p]["mu"] / (1 - B1) if p in opt.state
                                        else torch.zeros_like(p)) for n, p in params.items()})
        change = leaf_norms({n: p.detach() - weights[n] for n, p in params.items()})
    return {"losses": losses, "grad1": grad1, "change": change}


def run(ctx) -> dict:
    from pixel_embedded_affinity_torch.train.graph_step import GraphedStep
    from pixel_embedded_affinity_torch.train.loop import (init_state, make_train_step,
                                                          resident_sampler)

    traffic = ctx.cell.traffic
    cfg = ctx.program_config()
    s = int(traffic["steps_per_call"])
    cfg.train.steps_per_call = s
    n_check = int(traffic["check_steps"])
    dev = torch.device(ctx.device)
    is_3d = cfg.model.arch == "unet_pni_deep"

    arrays = make_data(ctx, cfg)
    ctx.note(f"data {time.perf_counter() - ctx.t_start:.2f} s")
    state = init_state(cfg, dev)
    ctx.note(f"model {time.perf_counter() - ctx.t_start:.2f} s")
    ref_mod = ctx.reference_module()
    weights = ctx.weights(ref_mod.build(ctx.cell.config["model"]))
    state.model.load_state_dict(weights)
    step_fn = make_train_step(cfg)
    runner = GraphedStep(step_fn, state, graph=dev.type == "cuda")
    ctx.note(f"weights and step {time.perf_counter() - ctx.t_start:.2f} s")
    next_batch = resident_sampler(cfg, arrays, dev)
    del arrays
    ctx.note(f"state and sampler {time.perf_counter() - ctx.t_start:.2f} s")
    loop = Loop(runner, next_batch, state.optimizer, s, cfg.train.display_freq)
    names = {p: n for n, p in state.model.named_parameters()}
    prog = {}
    for k in range(s):  # the first call, with the snapshots the check reads
        loop.step()
        if k == 0:
            prog["grad1"] = leaf_norms(_first_moment(state.optimizer, names))
        if k + 1 == n_check:
            prog["change"] = leaf_norms({n: p.detach() - weights[n] for p, n in names.items()})
    loop.after_call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.note(f"setup {setup_s:.2f} s (capture {runner.capture_s})")

    out = {"setup_s": setup_s, "end_to_end": {}, "failed": 0}
    batch_size = cfg.train.batch_size
    if not ctx.trace:
        calls = 0
        while time.perf_counter() - t0 < ctx.seconds:
            with record_function("bench.call"):
                loop.call()
            calls += 1
        loop.drain()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        out["attempted"] = calls * s
        out["end_to_end"]["train_samples_per_s"] = calls * s * batch_size / wall
        ctx.note(f"window {wall:.3f} s, {calls} calls of {s} steps")
    else:
        n = int(traffic["trace_calls"])
        loop.call()  # one call of the loop before the stretch
        record = capture(loop.call, n)
        loop.drain()
        spatial = cfg.data.crop_size if is_3d else (cfg.data.size, cfg.data.size)
        record.update(steps=n * s, peaks=yardstick.chip_peaks(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            step_flops=4 * ref_mod.forward_flops(ctx.cell.config["model"], batch_size,
                                                 spatial))
        if not is_3d:
            record["conv2d_shapes"] = conv2d_shapes(
                ref_mod.build(ctx.cell.config["model"]),
                (batch_size, cfg.model.input_nc) + tuple(spatial),
                ref_mod.NO_GRADIENT)
        out["record"] = record
        out["attempted"] = (n + 1) * s
    out["failed"] = sum(1 for v in loop.losses if not math.isfinite(v))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog["losses"] = loop.losses[:n_check]

    # the check, once the program's training state is freed
    del runner, state, loop, names
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    batches = []
    for k in range(n_check):
        b = step_fn.ema_batch(next_batch(k), k)
        batches.append({key: b[key] for key in ("image", "seg", "ema_image", "rules")})
    ref = reference_snapshot(ctx, cfg, batches, weights, tf32=False)
    kind = ctx.cell.config["synth"]["kind"]
    out["checks"] = dict(compare(prog, ref), teacher_view_gap=teacher_view_gap(batches, is_3d),
                         sampler_align_gap=max(alignment_gap(kind, b["image"], b["seg"])
                                               for b in batches))
    out["snapshots"] = {"program": prog, "reference": ref}
    out["batches"] = batches
    out["weights"] = weights
    return out
