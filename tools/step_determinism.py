#!/usr/bin/env python3
"""Are the port's training steps bit-reproducible on the card, and what
does the deterministic upsampling backward cost?

    python3 tools/step_determinism.py [--steps 10] [--presets cvppp,bbbc039v1,ac3ac4]
                                      [--dtypes float32,bfloat16]

For each full-width preset and compute dtype, ``train()`` runs ``--steps``
steps from the device-resident sampler over ``chip_smoke.py``'s synthetic
data (no validation), from one seed, four times in turns: as the parent
tree ran them ("parent": PyTorch's own backward of ``F.interpolate``, its
atomic scatter, and the 3D step without cuDNN's deterministic algorithms),
as shipped ("shipped": the gather kernel of ``csrc/upsample_bwd.cu``, and
the 3D step under ``deterministic_convs``), shipped again, parent again.
Each run prints its warm median ms/step (steps 2.., host clock around
``torch.cuda.synchronize``) and the two runs of each form are compared:
every logged loss and every parameter and buffer bit for bit, or the
largest difference; where the shipped runs differ, one step twice from the
same state names the first module output or parameter gradient that
differs (``chip_smoke.first_difference``). Then two shipped runs with
``torch.backends.cudnn.deterministic`` set for the whole step (its cost
where the shipped step does not set it), and one run under
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

    if preset == "cvppp":
        return pack_cvppp_arrays(smoke.leaf_pairs(4, 530, 500, smoke.SEED))
    if preset == "bbbc039v1":
        return smoke.bbbc_setup()[0]
    return smoke.train3d_data()[0][0]


def run(preset: str, dtype: str, data, steps: int, label: str) -> dict:
    """``steps`` steps of train(); {ms, losses, state}."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import train

    out = os.path.join(REPO, "build", "step_determinism", f"{preset}_{dtype}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(preset, {"model": {"dtype": dtype},
                               "train": {"if_valid": False, "display_freq": 1,
                                         "save_freq": 10 ** 6},
                               "save_path": os.path.join(out, "models")})
    timing: dict = {}
    state, _ = train(cfg, max_iters=steps, data_override=(data, []), device="cuda",
                     log_dir=os.path.join(out, "log"), timing=timing)
    torch.cuda.synchronize()
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    ms = 1e3 * float(np.median(np.add(timing["data_s"][1:], timing["step_s"][1:])))
    print(f"[{preset} {dtype}] {label}: {ms:.4f} ms/step (warm median of steps 2..{steps}), "
          f"losses {losses}")
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


def as_parent(on: bool):
    """Run the steps as the parent tree did (on) or as shipped (off): the
    models' upsampling through PyTorch's own autograd of F.interpolate and
    the 3D step without cuDNN's deterministic algorithms."""
    import contextlib

    from pixel_embedded_affinity_torch.device import deterministic_convs
    from pixel_embedded_affinity_torch.ops import upsample_cuda as U
    from pixel_embedded_affinity_torch.train import train_step

    if on:
        U.UpsampleAlignCorners.apply = U.upsample_fwd
        train_step.deterministic_convs = contextlib.nullcontext
    else:
        if "apply" in vars(U.UpsampleAlignCorners):
            del U.UpsampleAlignCorners.apply
        train_step.deterministic_convs = deterministic_convs


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
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--presets", default="cvppp,bbbc039v1,ac3ac4")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    from pixel_embedded_affinity_torch.ops.upsample_cuda import upsample_bwd

    rows = []
    for preset in args.presets.split(","):
        data = preset_data(preset)
        for dtype in args.dtypes.split(","):
            runs = {}
            for i, form in enumerate(("parent", "shipped", "shipped", "parent")):
                as_parent(form == "parent")
                upsample_bwd.launches = 0
                r = run(preset, dtype, data, args.steps, f"{form}, run {i + 1}")
                r["launches"] = upsample_bwd.launches
                runs.setdefault(form, []).append(r)
            as_parent(False)
            torch.backends.cudnn.deterministic = True
            det = [run(preset, dtype, data, args.steps, "shipped + cudnn.deterministic")
                   for _ in range(2)]
            torch.backends.cudnn.deterministic = False
            row = {"preset": preset, "dtype": dtype,
                   "parent_ms": [r["ms"] for r in runs["parent"]],
                   "shipped_ms": [r["ms"] for r in runs["shipped"]],
                   "cudnn_deterministic_ms": [r["ms"] for r in det],
                   "shipped_upsample_launches": [r["launches"] for r in runs["shipped"]],
                   "parent_upsample_launches": [r["launches"] for r in runs["parent"]],
                   "parent_repeat": compare(*runs["parent"]),
                   "shipped_repeat": compare(*runs["shipped"]),
                   "cudnn_deterministic_repeat": compare(*det)}
            if not row["shipped_repeat"]["bit_equal"]:
                row["shipped_first_difference"] = where_it_differs(preset, dtype, data)
            print(json.dumps(row))
            rows.append(row)
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
