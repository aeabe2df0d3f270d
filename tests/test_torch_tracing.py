"""The port's spans (``utils/profiling.py`` ``span``), on the CPU.

Under a ``torch.profiler`` the training step records ``pea.sample`` (the
device-resident sampler), ``pea.step`` and, inside it, ``pea.ema_view``,
both for the graph's step (``GraphedStep``, its body eager here) and for
the S=1 eager step; ``TiledInference3D.run`` records ``pea.tiled.run``
holding one ``pea.tiled.cut``, ``pea.tiled.predict`` and
``pea.tiled.stitch`` a tile batch and one ``pea.tiled.fetch``. Without a
profiler a span enters no ``record_function``, and the outputs are the
same bit for bit with a profiler running and without."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.parallel.tiling import TiledInference3D, tile_grid
from pixel_embedded_affinity_torch.train.graph_step import GraphedStep
from pixel_embedded_affinity_torch.train.loop import init_state, make_train_step, resident_sampler
from pixel_embedded_affinity_torch.utils import profiling
from pixel_embedded_affinity_torch.utils.profiling import span

from synth import blob_labels

FILTERS = (4, 6, 8, 12, 16)


def _arrays():
    rng = np.random.default_rng(3)
    pairs = []
    for i in range(3):
        lab = blob_labels(50, 50, grid=3, radius=6, seed=i)[:, 15:35]
        img = rng.random((50, 20, 3)).astype(np.float32) * 0.3
        img[lab > 0] += 0.5
        pairs.append((img, lab))
    return dd.pack_cvppp_arrays(pairs)


ARRAYS = _arrays()


def _train(kind: str, steps: int = 2):
    """``steps`` training steps of a tiny cvppp preset from the device
    sampler, by GraphedStep (``graphed``) or the eager step (``eager``);
    (losses, parameters)."""
    cfg = load_config("cvppp", {"model": {"filters": FILTERS}, "data": {"size": 64}})
    state = init_state(cfg, "cpu")
    step = make_train_step(cfg)
    next_batch = resident_sampler(cfg, ARRAYS, "cpu")
    runner = GraphedStep(step, state, graph=False) if kind == "graphed" else None
    losses = []
    for it in range(steps):
        batch = next_batch(it)
        _, metrics = step(state, batch) if runner is None else runner(batch)
        losses.append(metrics["loss"].clone())
    return torch.stack(losses), {k: p.detach().clone()
                                 for k, p in state.model.named_parameters()}


def _volume():
    return np.random.default_rng(5).random((5, 12, 14)).astype(np.float32)


def _serve():
    engine = TiledInference3D(crop_size=(4, 8, 8), stride=(2, 4, 4), padding=(1, 2, 2),
                              batch_size=5)
    return engine.run(_volume(), lambda t: torch.cat([t, 2 * t.sin()], 1), n_channels=2,
                      device="cpu")


def _traced(fn):
    """(fn(), [(name, start, end)] of the pea.* spans) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith("pea.")]


def _inside(span_, outer):
    return outer[1] <= span_[1] and span_[2] <= outer[2]


@pytest.mark.parametrize("kind", ["graphed", "eager"])
def test_a_training_step_records_sample_step_and_its_ema_view(kind):
    _, spans = _traced(lambda: _train(kind))
    names = [s[0] for s in spans]
    assert sorted(set(names)) == ["pea.ema_view", "pea.sample", "pea.step"]
    assert names.count("pea.sample") == names.count("pea.step") == 2
    steps = [s for s in spans if s[0] == "pea.step"]
    for s in spans:
        if s[0] == "pea.sample":
            assert not any(_inside(s, st) for st in steps)
    for st in steps:
        assert sum(1 for s in spans if s[0] == "pea.ema_view" and _inside(s, st)) == 1


def test_tiled_run_records_one_cut_predict_and_stitch_a_batch_and_one_fetch():
    _, spans = _traced(_serve)
    n_tiles = len(tile_grid((7, 16, 18), (4, 8, 8), (2, 4, 4)))
    batches = -(-n_tiles // 5)
    assert n_tiles % 5  # a ragged last batch
    names = [s[0] for s in spans]
    assert names.count("pea.tiled.run") == 1 and names.count("pea.tiled.fetch") == 1
    for stage in ("cut", "predict", "stitch"):
        assert names.count(f"pea.tiled.{stage}") == batches
    run = next(s for s in spans if s[0] == "pea.tiled.run")
    assert all(_inside(s, run) for s in spans)


def test_a_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with span("pea.test") as s:
        assert s.name == "pea.test"
    _train("graphed", steps=1)
    _serve()
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            with span("pea.test"):
                pass


def test_a_span_closes_its_annotation_when_the_block_raises():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with span("pea.test"):
                raise ValueError("inside")
        with span("pea.after"):
            pass
    names = [e.name for e in prof.events() if e.name.startswith("pea.")]
    assert names == ["pea.test", "pea.after"]


@pytest.mark.parametrize("kind", ["graphed", "eager", "tiled"])
def test_outputs_are_bit_equal_with_and_without_a_profiler(kind):
    fn = _serve if kind == "tiled" else (lambda: _train(kind))
    plain = fn()
    traced, spans = _traced(fn)
    assert spans
    if kind == "tiled":
        np.testing.assert_array_equal(traced, plain)
        return
    assert torch.equal(traced[0], plain[0])
    assert traced[1].keys() == plain[1].keys()
    assert all(torch.equal(traced[1][k], plain[1][k]) for k in plain[1])
