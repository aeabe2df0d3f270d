"""Readings for setting a cell's correctness limits, many seeds in one process.

    python3 benchmark/controls.py --workload <name> --seeds 101 102 ... [--out FILE]

For each seed it runs the cell's driver at the cell's own size with a short
window (the readings need none) and prints, as one JSON line:

* ``program``: the numbers compared, as a run of the benchmark reads them;
* ``control``: the same numbers of the control, the plain reference computed
  in the nearest precision below the configuration's (TF32 for float32 with
  TF32 off), put in the program's place and compared with the reference;
* training cells, ``half_batch``: the reference put in the program's place
  with half of each batch left out and the mean taken over the rest;
  ``unchanged``: the reference with its state left unchanged by its steps
  (rate 0; its first moment still holds the gradient); and
  ``wrong_rule``: the teacher's view put back by the inverse of its rule;
  ``misaligned``: the sampled labels flipped along x against their images.

A limit lies above the program's largest reading over a dozen seeds or more
and below the least of the control's (``limits/<workload>.json`` keeps both).
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, seconds: float) -> dict:
    import torch

    from benchmark import harness
    from benchmark.drivers import serve_tiled3d, train
    from benchmark.synth import alignment_gap

    ctx = harness.Context(cell, seed, seconds, False, "cuda:0", time.perf_counter(), None)
    res = harness.driver(cell.traffic["driver"]).run(ctx)
    out = {"seed": seed, "program": res["checks"]}
    if cell.traffic["driver"] == "train":
        cfg = ctx.program_config()
        ref = res["snapshots"]["reference"]
        ctl = train.reference_snapshot(ctx, cfg, res["batches"], res["weights"], tf32=True)
        out["control"] = train.compare(ctl, ref)
        half = [{k: v[:1] for k, v in b.items()} for b in res["batches"]]
        out["half_batch"] = train.compare(
            train.reference_snapshot(ctx, cfg, half, res["weights"], tf32=False), ref)
        lr = cfg.train.base_lr
        cfg.train.base_lr = 0.0  # the reference's state left unchanged by its steps
        out["unchanged"] = train.compare(
            train.reference_snapshot(ctx, cfg, res["batches"], res["weights"], tf32=False), ref)
        cfg.train.base_lr = lr
        kind = cell.config["synth"]["kind"]
        out["misaligned"] = {"sampler_align_gap": max(
            alignment_gap(kind, b["image"], b["seg"].flip(2 if kind == "leaves" else 3))
            for b in res["batches"])}
        wrong = [dict(b, rules=1 - b["rules"]) for b in res["batches"]]
        out["wrong_rule"] = {"teacher_view_gap": train.teacher_view_gap(
            wrong, cfg.model.arch == "unet_pni_deep")}
    else:
        gaps = []
        for _, i, _ in res["sample"]:
            vol = res["volumes"][i]
            ref = serve_tiled3d.reference_canvas(ctx, res["weights"], vol, tf32=False)
            ctl = serve_tiled3d.reference_canvas(ctx, res["weights"], vol, tf32=True)
            gaps.append(float((ctl - ref).abs().max()))
            del ref, ctl
        out["control"] = {"canvas_gap": max(gaps)}
    del res
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.resolve(args.workload)
    rows = []
    for seed in args.seeds:
        row = readings(cell, seed, args.seconds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in ("program", "control", "half_batch", "unchanged", "wrong_rule", "misaligned"):
        for name in rows[0].get(key, {}):
            vals = [r[key][name] for r in rows if key in r]
            summary[f"{key}.{name}"] = {"min": min(vals), "max": max(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
