"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the harness's look for a card and drives the rest of a run
at a tiny size on the CPU, with the cell's own limits, once as the program
is and once with one fault planted in it: a step that leaves its state
unchanged, a step over half of its batch (the mean taken over the rest), an
answer altered where it is produced. One card has no exchange between chips
to leave out. A sampler whose labels miss their images is caught by the
check of the sampled batches by themselves.
"""

import time

import pytest
import torch

from benchmark import harness
from conftest import tiny_cell

TRAIN = ["cvppp.train_graphed", "ac3ac4.train_graphed"]


def _run(name, seed=7):
    torch.set_num_threads(4)
    # 2D at 128x128: smaller plants' leaves are so small that a resize blends
    # a share of their inner pixels that reads as a misaligned sampler
    cell = tiny_cell(name, 128 if name.startswith("cvppp") else 64)
    return harness.run_cell(cell, seed, 0.1, False, "cpu", time.perf_counter(), log=None)


@pytest.mark.parametrize("name", TRAIN + ["ac3ac4.serve_affinity"])
def test_the_program_as_it_is_reads_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_caught(name, monkeypatch):
    from pixel_embedded_affinity_torch.train import optim

    monkeypatch.setattr(optim.AMSGrad, "_update", lambda self, group, params, scalars: None)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_over_half_of_its_batch_is_caught(name, monkeypatch):
    from pixel_embedded_affinity_torch.train import train_step

    for cls in (train_step.TrainStep2D, train_step.TrainStep3D):
        grads = cls.grads

        def half(self, model, batch, grads=grads):
            return grads(self, model, {k: v[: len(v) // 2] for k, v in batch.items()})

        monkeypatch.setattr(cls, "grads", half)
    res = _run(name)
    assert not res["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_loss_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from pixel_embedded_affinity_torch.train import graph_step

    call = graph_step.GraphedStep.__call__

    def altered(self, batch):
        pred, metrics = call(self, batch)
        return pred, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(graph_step.GraphedStep, "__call__", altered)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["loss_gap"]["value"] == pytest.approx(0.01, rel=1e-2)


def test_an_affinity_altered_where_it_is_produced_is_caught(monkeypatch):
    from pixel_embedded_affinity_torch.parallel import tiling

    run = tiling.TiledInference3D.run

    def altered(self, *args, **kwargs):
        canvas = run(self, *args, **kwargs)
        canvas[3, 5, 7, 11] += 0.01
        return canvas

    monkeypatch.setattr(tiling.TiledInference3D, "run", altered)
    res = _run("ac3ac4.serve_affinity")
    assert not res["correct"]
    assert res["checks"]["canvas_gap"]["value"] >= 0.009


@pytest.mark.parametrize("name", TRAIN)
def test_a_sampler_whose_labels_miss_their_images_is_caught(name, monkeypatch):
    from pixel_embedded_affinity_torch.data import device_data

    for fn in ("sample_cvppp_batch", "sample_ac3ac4_batch"):
        draw = getattr(device_data, fn)

        def flipped(*args, draw=draw, **kwargs):
            batch = draw(*args, **kwargs)
            return dict(batch, seg=batch["seg"].flip(2 if batch["seg"].dim() == 3 else 3))

        monkeypatch.setattr(device_data, fn, flipped)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["sampler_align_gap"]["value"] > res["checks"]["sampler_align_gap"]["limit"]
