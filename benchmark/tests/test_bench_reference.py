"""The plain reference agrees with the program's CPU path at a tiny size:
one training step's loss and every leaf's gradient with the models in
float64 (the targets and their weights stay float32 on both sides, as the
program builds them, so agreement is to float32's rounding of the weights),
the first steps' readings in float32, and the serving canvas."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import train as driver
from benchmark.reference import steps
from conftest import tiny_cell

CELLS = ["cvppp.train_graphed", "ac3ac4.train_graphed"]


def _cast(d: dict, dt) -> dict:
    return {k: v.to(dt) if v.is_floating_point() else v for k, v in d.items()}


@pytest.mark.parametrize("name", CELLS)
def test_one_step_agrees_in_float64(name):
    from pixel_embedded_affinity_torch.train.loop import (init_state, make_train_step,
                                                          resident_sampler)

    torch.set_num_threads(4)
    cell = tiny_cell(name)
    ctx = harness.Context(cell, 1234567, 0.1, False, "cpu", 0.0)
    cfg = ctx.program_config()
    step = make_train_step(cfg)
    batch = _cast(step.ema_batch(resident_sampler(cfg, driver.make_data(ctx, cfg), "cpu")(0), 0),
                  torch.float64)
    ref_mod = ctx.reference_module()
    weights = _cast(ctx.weights(ref_mod.build(cell.config["model"])), torch.float64)

    state = init_state(cfg, "cpu")
    prog = state.model.double()
    prog.load_state_dict(weights)
    _, metrics = step.grads(prog, batch)
    ref = ref_mod.build(cell.config["model"]).double()
    ref.load_state_dict(weights)
    ref.train()
    if cfg.model.arch == "unet_pni_deep":
        loss = steps.loss_3d(ref, batch)
    else:
        loss = steps.loss_2d(ref, batch, cfg.data.shifts, cfg.data.neighbor)
    loss.backward()
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-6)
    rp = dict(ref.named_parameters())
    # leaves whose gradient is nought to rounding (a bias under BatchNorm) are
    # held to the median leaf's scale
    scale = float(torch.tensor([float(g.grad.abs().max()) for g in rp.values()
                                if g.grad is not None]).median())
    for n, p in prog.named_parameters():
        if rp[n].grad is None:
            assert p.grad is None
            continue
        torch.testing.assert_close(p.grad, rp[n].grad, rtol=1e-5,
                                   atol=1e-6 * scale)


def test_the_first_steps_of_the_3d_cell_agree_in_float32():
    torch.set_num_threads(4)
    res = harness.run_cell(tiny_cell("ac3ac4.train_graphed"), 99, 0.1, False, "cpu",
                           time.perf_counter(), log=None)
    c = res["checks"]
    assert c["loss_gap"]["value"] < 1e-5
    assert c["grad1_gap"]["value"] < 1e-4
    assert c["change_gap"]["value"] < 1e-2
    assert c["teacher_view_gap"]["value"] == 0.0
    assert res["correct"]


def test_the_serving_canvas_agrees():
    torch.set_num_threads(4)
    res = harness.run_cell(tiny_cell("ac3ac4.serve_affinity"), 5, 0.1, False, "cpu",
                           time.perf_counter(), log=None)
    assert res["checks"]["canvas_gap"]["value"] < 1e-5
    assert res["correct"]
