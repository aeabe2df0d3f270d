"""A CUDA graph of the training step against the eager step, on a card.

``train()`` at ``train.steps_per_call=2`` (the graph captured at step 2 and
replayed) against the eager run, 4 steps of the bbbc039v1 preset at
filters (4, 6, 8, 12, 16) on 64x64 crops in bfloat16, whose eager step is
bit-reproducible: every loss and every parameter bit for bit. The kernel
wrappers count the graphed run's first step (eager) and its capture, and
not the replays: half the eager run's launches. Without a card it skips; ``chip_smoke.py`` phase
26 runs the full-width presets.

With a data-parallel mesh, on one NCCL process group of world size 1
joined in this process: the same run at ``train.steps_per_call=2`` with
the mesh (the meshed step captured, on NCCL, and replayed) equal to the
eager run without one, bit for bit; and ``chip_smoke.nccl_capture_probe``,
``dist.all_reduce`` of the flat gradient's and a BatchNorm vector's sizes
captured in a CUDA graph, by SUM and by PREMUL_SUM(0.5), each replay
equal to the eager all-reduces and half its input (over one rank only the
PREMUL_SUM runs a NCCL kernel: an in-place SUM there issues no work).
Phase 24 runs the full-width ac3ac4 CLI so. On the card's machine, which
has no JAX, run this file without the tests' conftest:
``python -m pytest --noconftest tests/test_torch_steps_per_call_cuda.py``.
"""

import copy
import os
import socket

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_nuclei
from pixel_embedded_affinity_torch.ops.launch_count import launch_counts, reset_launch_counts
from pixel_embedded_affinity_torch.train import train


def _small_bbbc(tmp_path):
    arrays = dd.pad_bbbc_arrays(synthesize_nuclei(2, 96, 112, seed=5), padding=30)
    cfg = load_config("bbbc039v1", {
        "model": {"filters": (4, 6, 8, 12, 16), "dtype": "bfloat16"},
        "data": {"size": 64, "bbbc_padding": 30},
        "train": {"display_freq": 1, "if_valid": False}, "save_path": str(tmp_path)})
    return arrays, cfg


def _needs_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels run only there")


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps(tmp_path):
    _needs_a_card()
    arrays, cfg = _small_bbbc(tmp_path)
    runs = []
    for spc in (1, 2):
        c = copy.deepcopy(cfg)
        c.train.steps_per_call = spc
        c.name = f"spc{spc}"
        reset_launch_counts()
        timing = {}
        state, _ = train(c, max_iters=4, data_override=(arrays, []), device="cuda",
                         timing=timing)
        runs.append((state, timing, launch_counts()))
    (eager, te, le), (graphed, tg, lg) = runs
    assert tg["capture_s"] > 0 and te["loss"] == tg["loss"]
    assert any(le.values()) and le == {k: 2 * v for k, v in lg.items()}
    a, b = eager.model.state_dict(), graphed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def nccl_mesh(tmp_path):
    """One NCCL process group of world size 1 in this process, on cuda:0."""
    _needs_a_card()
    from pixel_embedded_affinity_torch.parallel.multihost import initialize

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh = initialize("cuda:0", backend="nccl", init_method=f"tcp://localhost:{port}",
                      rank=0, world_size=1)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_meshed_graphed_steps_on_nccl_equal_eager_steps(nccl_mesh, tmp_path):
    arrays, cfg = _small_bbbc(tmp_path)
    runs = []
    for spc, mesh in ((1, None), (2, nccl_mesh)):
        c = copy.deepcopy(cfg)
        c.train.steps_per_call = spc
        c.name = f"spc{spc}"
        timing = {}
        state, _ = train(c, max_iters=4, data_override=(arrays, []), device="cuda",
                         timing=timing, mesh=mesh)
        runs.append((state, timing))
    (eager, te), (graphed, tg) = runs
    assert tg["capture_s"] > 0 and te["loss"] == tg["loss"]
    a, b = eager.model.state_dict(), graphed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_nccl_collectives_replay_from_a_cuda_graph(nccl_mesh):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    probe = chip_smoke.nccl_capture_probe(nccl_mesh, 100_003)
    assert probe["equal"] and probe["capture_s"] > 0 and probe["replay_ms"] > 0
