"""The harness's training loop gives ``train()``'s losses, at a tiny size on
the CPU, and its calls fetch at ``train()``'s display points."""

import torch

from benchmark import harness
from benchmark.drivers import train as driver
from conftest import tiny_cell


def _config_and_arrays(name):
    cell = tiny_cell(name)
    ctx = harness.Context(cell, 2 ** 31 + 3, 0.1, False, "cpu", 0.0)
    cfg = ctx.program_config()
    cfg.train.steps_per_call = 4
    return cfg, driver.make_data(ctx, cfg)


def _harness_losses(cfg, arrays, n_calls):
    from pixel_embedded_affinity_torch.train.graph_step import GraphedStep
    from pixel_embedded_affinity_torch.train.loop import (init_state, make_train_step,
                                                          resident_sampler)

    state = init_state(cfg, "cpu")
    runner = GraphedStep(make_train_step(cfg), state, graph=False)
    loop = driver.Loop(runner, resident_sampler(cfg, arrays, "cpu"), state.optimizer,
                       4, cfg.train.display_freq)
    for _ in range(n_calls):
        loop.call()
    loop.drain()
    return loop.losses


def test_the_loop_gives_train_s_losses(tmp_path):
    from pixel_embedded_affinity_torch.train.loop import train

    torch.set_num_threads(4)
    for name in ("cvppp.train_graphed", "ac3ac4.train_graphed"):
        cfg, arrays = _config_and_arrays(name)
        cfg.save_path = str(tmp_path)
        timing: dict = {}
        train(cfg, max_iters=8, data_override=(arrays, None), device="cpu", timing=timing,
              log_dir=str(tmp_path / "log"))
        assert _harness_losses(cfg, arrays, 2) == timing["loss"]


def test_losses_are_fetched_at_the_display_points():
    fetched = []

    class Runner:
        def __call__(self, batch):
            return None, {"loss": torch.tensor(1.0)}

    class Opt:
        param_groups = [{}]

        def lr(self, group):
            return 1e-4

    loop = driver.Loop(Runner(), lambda it: {}, Opt(), 4, display_freq=10)
    real_drain = loop.drain
    loop.drain = lambda: (fetched.append(loop.it), real_drain())
    for _ in range(8):
        loop.call()
    assert loop.display == 12  # rounded up to whole calls, as train() rounds it
    assert fetched == [4, 12, 24]
