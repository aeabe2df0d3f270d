"""A CUDA graph of the training step against the eager step, on a card.

``train()`` at ``train.steps_per_call=2`` (the graph captured at step 2 and
replayed) against the eager run, 4 steps of the bbbc039v1 preset at
filters (4, 6, 8, 12, 16) on 64x64 crops in bfloat16, whose eager step is
bit-reproducible: every loss and every parameter bit for bit. The kernel
wrappers count the graphed run's first step (eager) and its capture, and
not the replays: half the eager run's launches. Without a card it skips; ``chip_smoke.py`` phase
26 runs the full-width presets.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_nuclei
from pixel_embedded_affinity_torch.ops.launch_count import launch_counts, reset_launch_counts
from pixel_embedded_affinity_torch.train import train


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels run only there")
    arrays = dd.pad_bbbc_arrays(synthesize_nuclei(2, 96, 112, seed=5), padding=30)
    cfg = load_config("bbbc039v1", {
        "model": {"filters": (4, 6, 8, 12, 16), "dtype": "bfloat16"},
        "data": {"size": 64, "bbbc_padding": 30},
        "train": {"display_freq": 1, "if_valid": False}, "save_path": str(tmp_path)})
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
