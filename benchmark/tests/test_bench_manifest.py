"""The manifest resolves every piece by name, keeps to the contract's forms,
and takes up an added file without an edit."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
MANIFEST = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell = harness.resolve(workload)
    assert cell.chips == 1
    assert os.path.exists(os.path.join(harness.BENCH, "drivers",
                                       cell.traffic["driver"] + ".py"))
    assert cell.limits, "a cell without limits could never read correct"
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_manifest_keeps_to_the_contract_forms():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_line(c) for c in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += WORKLOADS + [c["name"] for c in MANIFEST["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        assert sum(1 for w in MANIFEST["workloads"] if w["config"] == c["name"]) >= 1
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(harness.BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def _copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_added_traffic_metric_and_kernel_list_are_taken_up_without_an_edit(tmp_path):
    root = _copy_benchmark(tmp_path)
    bench = root / "benchmark"
    (bench / "traffic" / "test_only_mix.json").write_text(json.dumps(
        {"driver": "train", "steps_per_call": 2, "check_steps": 2, "trace_calls": 1}))
    (bench / "metrics" / "test_only_metric.py").write_text(
        "def read(record):\n    return 42.0\n")
    (bench / "layers" / "conv2d_bwd" / "test_only_impl.txt").write_text("my_new_kernel\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "cvppp.test_only_mix", "config": "cvppp",
                           "traffic": "test_only_mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "test_only_metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": "train_samples_per_s",
                           "workloads": ["cvppp.test_only_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve("cvppp.test_only_mix", root=str(root), bench=str(bench))
    assert cell.traffic["steps_per_call"] == 2
    assert [p["name"] for p in cell.per_layer] == ["test_only_metric"]
    assert harness.metric_reader("test_only_metric", bench=str(bench))({}) == 42.0
    assert "my_new_kernel" in harness.layer_patterns(bench=str(bench))["conv2d_bwd"]
    assert "wgrad_wgmma_kernel" in harness.layer_patterns(bench=str(bench))["conv2d_bwd"]


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.resolve("no_such.cell")
