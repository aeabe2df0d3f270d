#!/usr/bin/env python3
"""The three quality gates on one card at other widths and on the plain path.

    python3 tools/quality_card.py

Runs ``chip_smoke.py``'s gates (``GATES``, ``run_gate``: the JAX package's
fixed-seed train-to-quality gates, same data, steps and seeds) on the
card, each configuration ``RUNS`` times to show the run-to-run spread
(cuDNN's convolutions are not deterministic):

* ``gate`` width, through the kernels (``train.use_pallas``, as
  ``chip_smoke.py``'s quality phase runs them);
* ``gate`` width on the plain path (``train.use_pallas=False``: the
  affinities and the loss in plain PyTorch, differentiated by autograd),
  the control;
* the preset's full width (``cvppp`` and ``bbbc039v1`` 16..256, ``ac3ac4``
  28..80), through the kernels.

Prints one JSON line a run: the gate, its filters, the path, seconds of
``train()``, steps a second, the loss at the first and last display, the
validation's metrics (SBD/DiC/VOI/ARAND; AJI/F1/PQ for BBBC; affs_mse and
mutex VOI/ARAND for AC3/AC4, and the same two with each tile batch's own
BatchNorm statistics, ``batch_stats/``), the floors it misses and, at the
gates' width, the readings off the plain path's (``GATES``' ``card_plain``,
which these runs measure); then the card's name and power limit. Exits 1
when a run at the gates' width misses a floor that ``chip_smoke.py``
asserts (the 2D gates') or is off the plain path's readings, 0 without a
CUDA card (nothing to run).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as gates  # noqa: E402

RUNS = 2


def configurations() -> list:
    """(gate, width label, filters or None for the gate's, use_pallas)."""
    from pixel_embedded_affinity_torch.config import load_config

    out = []
    for name in gates.GATES:
        out += [(name, "gate", None, True), (name, "gate", None, False),
                (name, "preset", tuple(load_config(name).model.filters), True)]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("quality_card: no CUDA device; nothing run")
        return 0
    gates.phase_build()
    fixture = dict(np.load(gates.QUALITY_FIXTURE))
    missed = False
    for name, width, filters, use_pallas in configurations():
        for run in range(RUNS):
            path = "kernels" if use_pallas else "plain"
            r = gates.run_gate(name, fixture, filters=filters, use_pallas=use_pallas,
                               out=os.path.join(REPO, "build", "quality_card",
                                                f"{name}-{width}-{path}-{run}"))
            r.update(width=width, run=run, misses=gates.gate_misses(name, r))
            if width == "gate":
                r["off_plain"] = gates.gate_off_plain(name, r)
                missed |= bool(r["off_plain"]) or (name != "ac3ac4" and bool(r["misses"]))
            print(json.dumps(r), flush=True)
    print(gates.card_line())
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
