"""``train.steps_per_call`` S > 1 with a data-parallel mesh, on the CPU.

Two gloo ranks, spawned as ``tests/test_torch_dp_train.py`` spawns them
(``torch_dp_ranks.py``), run the graph's split of the meshed step (the
eager prelude, the static buffers, the body on this rank's shard of them,
its collectives on gloo; on the card the body is one CUDA graph on NCCL):

* ``train()`` on the cvppp, bbbc039v1 and ac3ac4 presets at filters (4, 6,
  8, 12, 16) on 64x64 (8x32x32) crops, global batch 2, in float64, over 7
  steps: at S=3 (two calls and a tail of one) every logged loss, every
  parameter and buffer and the optimizer's state equal the meshed S=1
  run's bit for bit, as ``tests/test_torch_steps_per_call.py`` holds them
  without a mesh; the two ranks end bit-equal.
* one call of S=2 on ``tests/test_torch_dp_train.py``'s step cases (global
  batch 8, float32) against JAX's meshed step applied twice as its loop's
  ``multi_fn`` scans it (``lax.scan`` over two stacked batches on the
  conftest's 8-device CPU mesh): each loss and every parameter and
  BatchNorm statistic at ``test_dp_step_matches_jax_meshed_step``'s TOL.
* a mesh on gloo asked to capture raises before any step (``train()``
  builds its ``GraphedStep`` before the first step); on the CPU gloo runs
  the body eagerly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import torch.distributed as dist

from pixel_embedded_affinity_tpu.parallel import get_mesh, replicated_sharding

from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_nuclei, synthesize_volume
from pixel_embedded_affinity_torch.parallel import Mesh
from pixel_embedded_affinity_torch.train import GraphedStep, TrainState

import torch_dp_ranks as R
from synth import blob_labels

TOL = dict(rtol=3e-3, atol=2.5e-4)  # tests/test_dp_parity.py's, test_dp_train.py's
PRESETS = ("cvppp", "bbbc039v1", "ac3ac4")
RUN_ITERS = 7
SPC = 3
SCAN = 2  # steps of the JAX scan and of the port's call


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lab = blob_labels(50, 50, grid=3, radius=6, seed=seed + i)[:, 15:35]
        img = rng.random((50, 20, 3)).astype(np.float32) * 0.3
        img[lab > 0] += 0.5
        out.append((img, lab))
    return out


def _arrays(preset):
    if preset == "cvppp":
        return dd.pack_cvppp_arrays(_leaves(3, 0))
    if preset == "bbbc039v1":
        return dd.pad_bbbc_arrays(synthesize_nuclei(2, 96, 112, seed=5), padding=30)
    return dd.load_ac3ac4_arrays("", train_split=12, crop_z=8,
                                 arrays=synthesize_volume(14, 64, 64, n_cells=10, seed=1))


def _scan_case(kind):
    model = R.make_model(kind)
    return {"what": "graphed", "kind": kind,
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "batches": [R.make_batch(kind, s) for s in range(1, SCAN + 1)]}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spc_runs")
    out = {}
    for preset in PRESETS:
        arrays = _arrays(preset)
        for spc in (1, SPC):
            out[f"{preset}-s{spc}"] = {"what": "train", "preset": preset, "arrays": arrays,
                                       "steps": RUN_ITERS, "steps_per_call": spc,
                                       "save_path": str(tmp / f"{preset}-s{spc}")}
    for kind in R.KINDS:
        out[f"scan-{kind}"] = _scan_case(kind)
    return out


@pytest.fixture(scope="module")
def launched(cases, tmp_path_factory):
    """The two ranks, started at once: they run while this process compiles
    JAX's scans."""
    return R.Ranks(2, tmp_path_factory.mktemp("dp_spc"), cases)


@pytest.fixture(scope="module")
def jax_scans(cases, launched):
    """JAX's meshed step scanned over SCAN stacked batches, as its loop's
    ``multi_fn``: (each step's loss, the state after the scan as a port
    state dict), by kind."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from test_torch_dp_train import _jax_setup

    devices = jax.devices()
    assert len(devices) == 8  # the virtual CPU mesh of tests/conftest.py
    mesh = get_mesh(devices)
    rsh, stacked = replicated_sharding(mesh), NamedSharding(mesh, P(None, "data"))
    out = {}
    for kind in R.KINDS:
        case = cases[f"scan-{kind}"]
        model = R.make_model(kind)
        model.load_state_dict(case["state_dict"])
        step, state, to_port = _jax_setup(kind, model)

        def multi_fn(state, batches):
            def body(s, b):
                s2, _, m = step(s, b)
                return s2, m["loss"]
            return jax.lax.scan(body, state, batches)

        batches = {k: np.stack([b[k] for b in case["batches"]]) for k in case["batches"][0]}
        jit_multi = jax.jit(multi_fn, in_shardings=(rsh, {k: stacked for k in batches}))
        new, losses = jit_multi(jax.device_put(state, rsh),
                                {k: jax.device_put(v, stacked) for k, v in batches.items()})
        new = jax.device_get(new)
        out[kind] = ([float(x) for x in np.asarray(losses)],
                     to_port({"params": new.params, "batch_stats": new.batch_stats}))
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_scans):
    return launched.results()


@pytest.mark.parametrize("preset", PRESETS)
def test_meshed_three_steps_a_call_equal_single_steps_in_float64(ranks, preset):
    for r in range(2):
        one, three = ranks[r][f"{preset}-s1"], ranks[r][f"{preset}-s{SPC}"]
        assert one["step"] == three["step"] == RUN_ITERS and len(one["loss"]) == RUN_ITERS
        assert one["count"] == three["count"] == RUN_ITERS
        assert one["loss"] == three["loss"]
        assert next(iter(one["state"].values())).dtype == torch.float64
        for k, v in one["state"].items():
            assert torch.equal(v, three["state"][k]), (r, k)
        for p, q in zip(one["moments"], three["moments"]):
            assert set(p) == set(q) == {"mu", "nu", "nu_max"}
            assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("preset", PRESETS)
def test_meshed_steps_per_call_ranks_stay_equal(ranks, preset):
    for spc in (1, SPC):
        a, b = ranks[0][f"{preset}-s{spc}"], ranks[1][f"{preset}-s{spc}"]
        assert a["loss"] == b["loss"]
        assert all(torch.equal(v, b["state"][k]) for k, v in a["state"].items()), spc


@pytest.mark.parametrize("kind", R.KINDS)
def test_meshed_call_matches_jax_meshed_scan(ranks, jax_scans, kind):
    losses, exp = jax_scans[kind]
    got = ranks[0][f"scan-{kind}"]
    assert len(got["states"]) == len(losses) == SCAN
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], losses, **TOL)
    for k, v in exp.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got["states"][-1][k].numpy(), v.numpy(), err_msg=k,
                                       **TOL)
    other = ranks[1][f"scan-{kind}"]["states"][-1]
    assert all(torch.equal(v, other[k]) for k, v in got["states"][-1].items())


@pytest.fixture
def gloo_mesh(tmp_path):
    """A one-rank gloo process group in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg_init", rank=0,
                            world_size=1)
    try:
        yield Mesh(dist.group.WORLD, 0, 1, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def test_a_gloo_mesh_asked_to_capture_raises(gloo_mesh):
    case = _scan_case("cvppp")
    step, state, batches = R.build_case(case, gloo_mesh)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(RuntimeError, match="only NCCL's collectives can be captured"):
        GraphedStep(step, state, graph=True)
    assert state.step == 0
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in before.items())
    # on the CPU the same mesh runs the split eagerly: one step, as the plain step
    runner = GraphedStep(step, state, graph=False)
    _, metrics = runner(batches[0])
    ref_step, ref_state, _ = R.build_case(case)
    _, ref = ref_step(ref_state, batches[0])
    assert isinstance(state, TrainState) and state.step == 1
    assert float(metrics["loss"]) == float(ref["loss"])
