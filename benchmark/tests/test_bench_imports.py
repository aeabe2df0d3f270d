"""What the harness and the reference load, compared by whole top-level
module name, in fresh processes."""

import json
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def _loaded(code: str) -> set:
    script = (f"import sys, json\nsys.path.insert(0, {ROOT!r})\n{code}\n"
              "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_the_harness_loads_no_jax_and_no_jax_package():
    code = """
import time, copy
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from benchmark import harness, trace, synth, flops, controls
from benchmark.drivers import train, serve_tiled3d
import benchmark.run
for m in harness.manifest()["per_layer"]:
    harness.metric_reader(m["name"])
harness.run_cell(tiny_cell("ac3ac4.serve_affinity"), 3, 0.1, False, "cpu", time.perf_counter(),
                 log=None)
""".format(tests=harness.os.path.join(harness.BENCH, "tests"))
    tops = _loaded(code)
    assert "pixel_embedded_affinity_torch" in tops  # the program under test ran
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = _loaded("import benchmark.reference.ops, benchmark.reference.steps, "
                   "benchmark.reference.amsgrad, benchmark.reference.tiled, "
                   "benchmark.reference.resunet2d_deep, benchmark.reference.unet_pni_deep")
    assert not tops & (set(harness.FORBIDDEN) | {"pixel_embedded_affinity_torch"})


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded({"jax.numpy": 1, "os": 1}) == ["jax"]
    assert harness.forbidden_loaded({"jaxtyping": 1, "pixel_embedded_affinity_torch.ops": 1,
                                     "flaxen": 1}) == []
    assert harness.forbidden_loaded({"pixel_embedded_affinity_tpu.models": 1}) == [
        "pixel_embedded_affinity_tpu"]
