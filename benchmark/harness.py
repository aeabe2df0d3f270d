"""The benchmark's harness: it finds a cell's pieces by name and runs it once.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
harness finds

* the configuration in ``configs/<config>.json`` (the program's preset and
  overrides, the synthetic data's sizes, what was assumed or reduced);
* the traffic mix in ``traffic/<traffic>.json``, whose ``driver`` names the
  general loop in ``drivers/<driver>.py`` that reads it;
* each per-layer metric's reader in ``metrics/<metric>.py``;
* each layer's device-kernel name lists in ``layers/<layer>/*.txt``, one file
  an implementation;
* the limits of a cell's correctness numbers in ``limits/<workload>.json``.

A later change adds a cell, a configuration, a traffic mix, a metric or a
kernel-name list by adding files; none of these is named in the code.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "pixel_embedded_affinity_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    """One workload of the manifest with its pieces resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict = field(default_factory=dict)


def resolve(workload: str, root: str = ROOT, bench: str = BENCH) -> Cell:
    """The cell ``workload`` of the manifest under ``root``, its configuration,
    traffic, metrics and limits read from the files under ``bench``."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(bench, "limits", workload + ".json")
    limits = load_json(limits_path)["limits"] if os.path.exists(limits_path) else {}
    return Cell(workload, int(w["chips"]), config, traffic,
                [e for e in m["end_to_end"] if _applies(e, workload)],
                [p for p in m["per_layer"] if _applies(p, workload)], limits)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: str = BENCH):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(bench, "metrics", name + ".py")
    return load_file_module(path, "bench_metric_" + name.replace(".", "_")).read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def layer_patterns(bench: str = BENCH) -> dict:
    """{layer: [kernel-name substrings]} from every ``layers/<layer>/*.txt``
    (one substring a line; blank lines and ``#`` comments skipped)."""
    out: dict = {}
    base = os.path.join(bench, "layers")
    for layer in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        pats = out.setdefault(layer, [])
        for fname in sorted(os.listdir(os.path.join(base, layer))):
            if fname.endswith(".txt"):
                with open(os.path.join(base, layer, fname)) as f:
                    pats += [ln.strip() for ln in f
                             if ln.strip() and not ln.strip().startswith("#")]
    return out


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level modules that ``modules`` (default
    ``sys.modules``) holds, compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in FORBIDDEN if t in tops)


def make_weights(model, seed: int, device) -> dict:
    """A state dict for ``model``'s keys drawn from ``seed`` on ``device`` in
    two calls: conv weights He-normal (sqrt(2 / fan_in)), conv biases N(0,
    0.05^2), BatchNorm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2), running
    means N(0, 0.1^2), running variances U(0.5, 1.5), counts 0."""
    import torch

    from .synth import generator

    mods = dict(model.named_modules())
    sd = model.state_dict()
    normal, uniform = [], []
    for key, t in sd.items():
        mod_name, leaf = key.rsplit(".", 1)
        mod = mods[mod_name]
        if leaf == "num_batches_tracked":
            continue
        if leaf == "running_var":
            uniform.append((key, t.shape, 1.0, 0.5))
        elif isinstance(mod, torch.nn.modules.conv._ConvNd) and leaf == "weight":
            fan_in = t[0].numel()
            normal.append((key, t.shape, math.sqrt(2.0 / fan_in), 0.0))
        elif leaf == "weight":
            normal.append((key, t.shape, 0.1, 1.0))
        elif leaf == "bias" and isinstance(mod, torch.nn.modules.conv._ConvNd):
            normal.append((key, t.shape, 0.05, 0.0))
        else:
            normal.append((key, t.shape, 0.1, 0.0))
    gen = generator(seed, 7, device)
    out = {k: torch.zeros_like(t, device=device) for k, t in sd.items()}
    for entries, draw in ((normal, torch.randn), (uniform, torch.rand)):
        flat = draw(sum(math.prod(s) for _, s, _, _ in entries), generator=gen, device=device)
        i = 0
        for key, shape, scale, shift in entries:
            n = math.prod(shape)
            out[key] = flat[i:i + n].view(shape) * scale + shift
            i += n
    return out


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and the helpers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    log: object = None

    def note(self, msg: str):
        if self.log is not None:
            print(f"[bench] {msg}", file=self.log, flush=True)

    def program_config(self):
        """The program's Config: the preset, then the configuration file's
        overrides, the run's seed as the training seed."""
        from pixel_embedded_affinity_torch.config import load_config

        c = self.cell.config
        cfg = load_config(c["preset"], {k: c[k] for k in ("model", "train", "data") if k in c})
        cfg.train.random_seed = int(self.seed)
        return cfg

    def reference_module(self):
        from .reference import model_module

        return model_module(self.cell.config["model"]["arch"])

    def weights(self, model) -> dict:
        return make_weights(model, self.seed, self.device)


def check_limits(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    below its limit; a number without a limit is not correct."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=sys.stderr) -> dict:
    """Run one cell once; returns the result object (without the device check
    a run on the card makes first)."""
    import torch

    ctx = Context(cell, seed, seconds, trace, device, t_start, log)
    res = driver(cell.traffic["driver"]).run(ctx)
    correct, checks = check_limits(res["checks"], cell.limits)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    result = {
        "correct": bool(correct and res["failed"] == 0),
        "attempted": int(res["attempted"]),
        "failed": int(res["failed"]),
        "metrics": {},
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(res["memory_peak_bytes"])},
    }
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = dict(res["end_to_end"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": units[m["name"]]}
    else:
        record = res["record"]
        record["layers"] = layer_patterns()
        for m in cell.per_layer:
            value = metric_reader(m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
        from .trace import breakdown, busy_seconds

        result["device"]["busy_s"] = busy_seconds(record)
        result["device"]["window_s"] = record["window_s"]
        result["breakdown"] = breakdown(record)
    result["checks"] = checks
    return result


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
