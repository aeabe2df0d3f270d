#!/usr/bin/env python3
"""Are the port's training steps bit-reproducible on the card, and what
does the deterministic backward of the 2D convs cost?

    python3 tools/step_determinism.py [--steps 8] [--presets cvppp,bbbc039v1,ac3ac4]
                                      [--dtypes float32,bfloat16] [--steps-per-call 1,4]

(``--presets`` also takes cvppp_resnet50 and cvppp_resnet101, on cvppp's
data.)

For each full-width preset, compute dtype and ``train.steps_per_call``,
``train()`` runs ``--steps`` steps from the device-resident sampler over
``chip_smoke.py``'s synthetic data (no validation), from one seed, four
times in turns: as the parent tree ran them ("parent": cuDNN's default
backward of the 2D models' convs), as shipped ("shipped": CWg and CXg of
``csrc/conv_grad.cu`` for every stride-1 1x1 and 3x3 float32 conv, cuDNN's
deterministic algorithms for the ResNets' 7x7 and strided ones),
shipped again, parent again. Each run prints its warm median ms/step
(steps 2.., host clock around ``torch.cuda.synchronize``) and the two runs
of each form are compared: every logged loss and every parameter and
buffer bit for bit, or the largest difference; where the shipped runs
differ, one step twice from the same state names the first module output
or parameter gradient that differs (``chip_smoke.first_difference``).
Then steady steps of each form by CUDA events, eager and as a CUDA graph
(``GraphedStep``), in turns parent, shipped, shipped, parent (the sampler's
draw and the EMA view included, as phase 26 times them), and the host's
time to queue an eager step's forward and its backward beside their device
time, in the same turns three times over (what the Python backward of the
convs adds to a host-bound step). At
``steps_per_call`` 1, two shipped runs with
``torch.backends.cudnn.deterministic`` set for the whole step (what
cuDNN's own deterministic algorithms cost), and one run under
``torch.use_deterministic_algorithms(True, warn_only=True)``, which names
every operation on the path that PyTorch knows to be nondeterministic.
Ends with the card's name and power limit. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def preset_data(preset: str):
    """The device-resident training arrays of ``chip_smoke.py``'s training
    phases for ``preset``."""
    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays

    if preset.startswith("cvppp"):
        return pack_cvppp_arrays(smoke.leaf_pairs(4, 530, 500, smoke.SEED))
    if preset == "bbbc039v1":
        return smoke.bbbc_setup()[0]
    return smoke.train3d_data()[0][0]


def run(preset: str, dtype: str, data, steps: int, label: str, spc: int = 1) -> dict:
    """``steps`` steps of train() at ``train.steps_per_call=spc``; {ms,
    losses, state}."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import train

    out = os.path.join(REPO, "build", "step_determinism", f"{preset}_{dtype}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(preset, {"model": {"dtype": dtype},
                               "train": {"if_valid": False, "display_freq": 1,
                                         "save_freq": 10 ** 6, "steps_per_call": spc},
                               "save_path": os.path.join(out, "models")})
    timing: dict = {}
    state, _ = train(cfg, max_iters=steps, data_override=(data, []), device="cuda",
                     log_dir=os.path.join(out, "log"), timing=timing)
    torch.cuda.synchronize()
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    ms = 1e3 * float(np.median(np.add(timing["data_s"][1:], timing["step_s"][1:])))
    print(f"[{preset} {dtype} spc={spc}] {label}: {ms:.4f} ms/step (warm median of steps "
          f"2..{steps}), losses {losses}")
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return {"ms": ms, "losses": losses, "state": sd}


def compare(a: dict, b: dict) -> dict:
    """Bit equality of two runs' losses and states, else the largest
    differences."""
    import torch

    loss_diff = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    first = next((i + 1 for i, (x, y) in enumerate(zip(a["losses"], b["losses"])) if x != y),
                 None)
    differ = [k for k in a["state"] if not torch.equal(a["state"][k], b["state"][k])]
    param = max((float((a["state"][k].double() - b["state"][k].double()).abs().max())
                 for k in differ), default=0.0)
    return {"bit_equal": not differ and loss_diff == 0, "first_step_that_differs": first,
            "max_loss_diff": loss_diff, "tensors_that_differ": len(differ),
            "first_tensor_that_differs": differ[0] if differ else None,
            "max_tensor_diff": param}


_SHIPPED = None  # Conv2d's shipped forward, kept while the parent's is in place


def as_parent(on: bool):
    """Run the steps as the parent tree did (on: every 2D conv's backward
    by cuDNN's default algorithms, through autograd of ``F.conv2d``) or as
    shipped (off: ``models/common.py``'s ``Conv2d``, whose float32 training
    convs take CWg and CXg, or cuDNN's deterministic algorithms where CWg
    and CXg do not serve them)."""
    global _SHIPPED
    from pixel_embedded_affinity_torch.models import common

    if _SHIPPED is None:
        _SHIPPED = vars(common.Conv2d)["forward"]
    common.Conv2d.forward = common._CastConv.forward if on else _SHIPPED


def event_ms(preset: str, dtype: str, data, graphed: bool, steps: int = 20) -> float:
    """ms a step by CUDA events over ``steps`` steady steps from a fresh
    state (after two warm-up steps: with ``graphed``, the warm-up and the
    capture), the sampler's draw and the EMA view included."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.graph_step import GraphedStep
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = load_config(preset, {"model": {"dtype": dtype}})
    state = init_state(cfg, "cuda")
    next_batch = resident_sampler(cfg, data, torch.device("cuda"))
    step_fn = make_train_step(cfg)
    if graphed:
        runner = GraphedStep(step_fn, state, graph=True)

        def one():
            runner(next_batch(state.step))
    else:
        def one():
            step_fn(state, next_batch(state.step))
    one()
    one()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        one()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def host_ms(preset: str, dtype: str, data, steps: int = 20) -> dict:
    """Medians over ``steps`` eager steps from a fresh state (after two
    warm-up steps) of the host's time to return from the forward (the loss)
    and from the backward (``loss.backward()``, and on a mesh its
    all-reduce), the device synchronised before each step, beside each
    part's device time by CUDA events. Where a part's host time is below
    its device time, the host queued it without waiting for the device."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = load_config(preset, {"model": {"dtype": dtype}})
    state = init_state(cfg, "cuda")
    next_batch = resident_sampler(cfg, data, torch.device("cuda"))
    step = make_train_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    got: dict = {k: [] for k in ("forward_host_ms", "backward_host_ms", "forward_device_ms",
                                 "backward_device_ms")}
    for i in range(steps + 2):
        batch = next_batch(state.step)
        if step.device_ema:
            batch = step.ema_batch(batch, state.step)
        step._train_mode(state.model)
        torch.cuda.synchronize()
        with float32_convs():
            t0 = time.perf_counter()
            ev[0].record()
            loss, _, metrics = step.loss(state.model, batch)
            ev[1].record()
            t1 = time.perf_counter()
            step._backward(state.model, loss, metrics)
            ev[2].record()
            t2 = time.perf_counter()
        state.optimizer.step()
        state.step += 1
        torch.cuda.synchronize()
        if i >= 2:
            got["forward_host_ms"].append(1e3 * (t1 - t0))
            got["backward_host_ms"].append(1e3 * (t2 - t1))
            got["forward_device_ms"].append(ev[0].elapsed_time(ev[1]))
            got["backward_device_ms"].append(ev[1].elapsed_time(ev[2]))
    return {k: float(np.median(v)) for k, v in got.items()}


def where_it_differs(preset: str, dtype: str, data) -> str | None:
    """One shipped step twice from the same initial state and batch: the
    first module output or parameter gradient that differs."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = load_config(preset, {"model": {"dtype": dtype}})
    step = make_train_step(cfg)
    batch = resident_sampler(cfg, data, torch.device("cuda"))(0)
    if getattr(step, "device_ema", False):
        batch = step.ema_batch(batch, 0)
    return smoke.first_difference(lambda: init_state(cfg, "cuda").model,
                                  lambda m: step.grads(m, batch))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_determinism: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--presets", default="cvppp,bbbc039v1,ac3ac4")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--steps-per-call", default="1,4")
    args = ap.parse_args()
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad

    forms = ("parent", "shipped", "shipped", "parent")
    for preset in args.presets.split(","):
        data = preset_data(preset)
        for dtype in args.dtypes.split(","):
            for spc in map(int, args.steps_per_call.split(",")):
                runs = {}
                for i, form in enumerate(forms):
                    as_parent(form == "parent")
                    conv_wgrad.launches = conv_dgrad.launches = 0
                    r = run(preset, dtype, data, args.steps, f"{form}, run {i + 1}", spc)
                    r["launches"] = [conv_wgrad.launches, conv_dgrad.launches]
                    runs.setdefault(form, []).append(r)
                as_parent(False)
                row = {"preset": preset, "dtype": dtype, "steps_per_call": spc,
                       "parent_ms": [r["ms"] for r in runs["parent"]],
                       "shipped_ms": [r["ms"] for r in runs["shipped"]],
                       "shipped_cwg_cxg_launches": [r["launches"] for r in runs["shipped"]],
                       "parent_cwg_cxg_launches": [r["launches"] for r in runs["parent"]],
                       "parent_repeat": compare(*runs["parent"]),
                       "shipped_repeat": compare(*runs["shipped"])}
                if not row["shipped_repeat"]["bit_equal"]:
                    row["shipped_first_difference"] = where_it_differs(preset, dtype, data)
                print(json.dumps(row))
            for graphed in (False, True):
                ms = {}
                for form in forms:
                    as_parent(form == "parent")
                    ms.setdefault(form, []).append(event_ms(preset, dtype, data, graphed))
                as_parent(False)
                p, s = np.mean(ms["parent"]), np.mean(ms["shipped"])
                print(json.dumps({"preset": preset, "dtype": dtype,
                                  "path": "graphed" if graphed else "eager",
                                  "parent_event_ms": ms["parent"],
                                  "shipped_event_ms": ms["shipped"],
                                  "shipped_over_parent": s / p}))
            host = {}
            for form in forms * 3:
                as_parent(form == "parent")
                host.setdefault(form, []).append(host_ms(preset, dtype, data))
            as_parent(False)
            print(json.dumps({"preset": preset, "dtype": dtype, "path": "eager, host",
                              **{f"{form}_{k}": [h[k] for h in host[form]]
                                 for form in ("parent", "shipped") for k in host[form][0]}}))
            torch.backends.cudnn.deterministic = True
            det = [run(preset, dtype, data, args.steps, "shipped + cudnn.deterministic")
                   for _ in range(2)]
            torch.backends.cudnn.deterministic = False
            print(json.dumps({"preset": preset, "dtype": dtype,
                              "cudnn_deterministic_ms": [r["ms"] for r in det],
                              "cudnn_deterministic_repeat": compare(*det)}))
            # which operations PyTorch knows to be nondeterministic on this path
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    run(preset, dtype, data, 2, "shipped, use_deterministic_algorithms(warn_only)")
                finally:
                    torch.use_deterministic_algorithms(False)
            ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                          for w in caught if "deterministic" in str(w.message)})
            print(json.dumps({"preset": preset, "dtype": dtype, "nondeterministic_ops": ops}))
    print(smoke.card_line())
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[time] {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
