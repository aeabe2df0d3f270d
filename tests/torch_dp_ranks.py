"""Ranks for the port's data-parallel tests on the CPU.

:func:`run_ranks` spawns ``world`` processes that join one gloo process
group through a file under the test's temporary directory (no TCP port for
parallel test workers to race for) and run :func:`rank_main`'s cases on
their rank. Each child holds one intra-op thread, imports torch and the
port only (never JAX), reads its inputs from ``cases.pt`` and writes
``rank<r>.pt`` for the test to read. The case builders here are shared by
the tests' one-process references.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from synth import blob_labels, tile_labels_3d

TIMEOUT_S = 600
FILTERS = (4, 6, 8, 12, 16)
SHIFTS = [1, 3, 5, 9, 27]
B, SIDE, CROP = 8, 64, (6, 32, 32)
KINDS = ("cvppp", "3d", "bbbc")


def make_batch(kind: str, seed: int, dtype=np.float32) -> dict:
    """A global batch of B samples drawn with numpy. BBBC's foreground
    grows with the sample index (disks of radius 3 .. 17), so the shards of
    a split batch hold very different foreground fractions."""
    rng = np.random.default_rng(seed)
    if kind == "3d":
        seg = np.stack([tile_labels_3d(*CROP, 2, 3, 3) + 10 * i for i in range(B)])
        seg[rng.random(seg.shape) < 0.1] = 0
        shape = (B,) + CROP + (1,)
        out = {"image": rng.random(shape), "ema_image": rng.random(shape),
               "rules": rng.integers(0, 2, (B, 4)), "seg": seg}
    else:
        bbbc = kind == "bbbc"
        seg = np.stack([blob_labels(SIDE, SIDE, grid=3, radius=3 + 2 * i if bbbc else 8,
                                    seed=seed + i) for i in range(B)])
        shape = (B, SIDE, SIDE, 3)
        # BBBC images in [0, 1], CVPPP's ImageNet-normalised
        draw = rng.random if bbbc else (lambda s: rng.normal(size=s))
        out = {"image": draw(shape), "ema_image": draw(shape),
               "rules": rng.integers(0, 2, (B, 3)), "seg": seg}
    return {k: v.astype(np.int32 if k == "seg" else dtype) for k, v in out.items()}


def make_model(kind: str, seed: int = 0):
    """The port's model of a case, its weights drawn by torch from ``seed``."""
    from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep, UNetPNIEmbeddingDeep

    torch.manual_seed(seed)
    if kind == "3d":
        return UNetPNIEmbeddingDeep(1, FILTERS, 16)
    return ResidualUNet2DDeep(3, 2, FILTERS, 16)


def make_step(kind: str, mesh=None):
    """The case's step as the presets run it (the kernels and the fused
    loss, whose plain versions run on the CPU; BBBC with the mask head at
    weight 1000), the EMA view taken from the batch as the JAX step is
    given it."""
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.train import TrainStep2D, TrainStep3D

    if kind == "3d":
        return TrainStep3D(device_ema=False, mesh=mesh)
    return TrainStep2D(multi_offset(SHIFTS, 4), mask_weight=1000.0 if kind == "bbbc" else 0.0,
                       imagenet_norm=kind == "cvppp", device_ema=False, mesh=mesh)


def build_case(case: dict, mesh=None):
    """(step, state, batches as tensors) of a step case: its ``kind``, its
    model's ``state_dict`` (float32 or float64) and its global numpy
    ``batches``; AMSGrad as the JAX package's ``make_optimizer(1e-4)``."""
    from pixel_embedded_affinity_torch.train import AMSGrad, TrainState

    sd = case["state_dict"]
    model = make_model(case["kind"]).to(next(iter(sd.values())).dtype)
    model.load_state_dict(sd)
    state = TrainState(model, AMSGrad(model.parameters(), lr=1e-4, eps=0.01,
                                      weight_decay=1e-6))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in case["batches"]]
    return make_step(case["kind"], mesh), state, batches


def train_steps(step, state, batches) -> dict:
    """Run ``step`` over ``batches`` from ``state``: after each step its
    metrics, gradients and the model's state dict."""
    out = {"metrics": [], "grads": [], "states": []}
    for b in batches:
        _, metrics = step(state, b)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["grads"].append({n: p.grad.clone() for n, p in state.model.named_parameters()
                             if p.grad is not None})
        out["states"].append({k: v.clone() for k, v in state.model.state_dict().items()})
    return out


def graphed_steps(step, state, batches) -> dict:
    """:func:`train_steps` through the graph's split of the step
    (:class:`..train.graph_step.GraphedStep`, its body eager on the CPU):
    one call of ``len(batches)`` steps, as ``train.steps_per_call`` runs it."""
    from pixel_embedded_affinity_torch.train import GraphedStep

    runner = GraphedStep(step, state, graph=False)
    return train_steps(lambda st, b: runner(b), state, batches)


def train_config(preset: str, save_path: str, steps_per_call: int):
    """A small config of ``preset`` as ``tests/test_torch_steps_per_call.py``
    trains it: filters FILTERS, 64x64 (8x32x32) crops, a display every
    step, no validation, no save before the end."""
    from pixel_embedded_affinity_torch.config import load_config

    data = ({"crop_size": (8, 32, 32), "padding_3d": 10, "train_split": 12}
            if preset == "ac3ac4" else {"size": 64})
    if preset == "bbbc039v1":
        data["bbbc_padding"] = 30
    return load_config(preset, {"model": {"filters": FILTERS}, "data": data,
                                "train": {"display_freq": 1, "save_freq": 10 ** 6,
                                          "if_valid": False, "steps_per_call": steps_per_call},
                                "save_path": save_path})


def train_run(case: dict, mesh=None) -> dict:
    """``train()`` of ``case["preset"]`` on its resident ``arrays`` for
    ``steps`` steps at ``steps_per_call``, in float64 (the model and every
    floating tensor of each batch), on ``mesh``: each step's loss, and the
    final model and optimizer state."""
    from pixel_embedded_affinity_torch.train import loop

    init, sampler = loop.init_state, loop.resident_sampler

    def init_state(cfg, device):
        state = init(cfg, device)
        state.model.double()
        return state

    def resident_sampler(cfg, arrays, device):
        draw = sampler(cfg, arrays, device)
        return lambda step: {k: v.double() if v.is_floating_point() else v
                             for k, v in draw(step).items()}

    rank = 0 if mesh is None else mesh.rank
    cfg = train_config(case["preset"], os.path.join(case["save_path"], f"rank{rank}"),
                       case["steps_per_call"])
    loop.init_state, loop.resident_sampler = init_state, resident_sampler
    timing: dict = {}
    try:
        state, _ = loop.train(cfg, max_iters=case["steps"], data_override=(case["arrays"], None),
                              device="cpu", timing=timing, mesh=mesh)
    finally:
        loop.init_state, loop.resident_sampler = init, sampler
    opt = state.optimizer
    return {"loss": timing["loss"], "step": state.step, "count": opt.count,
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "moments": [{k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                        for st in opt.state.values()]}


def sampler_config(kind: str):
    """A small config of ``kind`` ("cvppp" or "3d") whose resident sampler
    the sampler case draws from (global batch 4; CVPPP's EMA view with its
    noise and blur)."""
    from pixel_embedded_affinity_torch.config import load_config

    if kind == "3d":
        return load_config("ac3ac4", {"model": {"filters": FILTERS}, "train": {"batch_size": 4},
                                      "data": {"crop_size": (8, 32, 32), "padding_3d": 10}})
    return load_config("cvppp", {"model": {"filters": FILTERS}, "train": {"batch_size": 4},
                                 "data": {"size": 64, "if_ema_noise": True,
                                          "if_ema_blur": True}})


def sampled_shards(kind: str, arrays, mesh=None, steps=(0, 5)) -> list:
    """This rank's shard of the resident sampler's batch with its EMA view
    drawn on the global batch, at each of ``steps``; all of it without a
    mesh."""
    from pixel_embedded_affinity_torch.parallel.mesh import shard_batch
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = sampler_config(kind)
    next_batch = resident_sampler(cfg, arrays, "cpu")
    step_fn = make_train_step(cfg, mesh)
    return [shard_batch(step_fn.ema_batch(next_batch(s), s), mesh) for s in steps]


def _tiles_predict(tiles):  # (B, 1, d, h, w) -> (B, 3, d, h, w), as tests/test_torch_tiling.py's
    t = tiles[:, 0]
    return torch.stack([t * 2.0, torch.flip(t, dims=(-1,)), torch.sin(3 * t) + t * t], dim=1)


def tiled_canvas(volume, engine_kw: dict, mesh=None):
    """The tiled engine's canvas of ``volume`` through a content-dependent
    predictor (on ``mesh`` when given), and the tile batch sizes it ran."""
    from pixel_embedded_affinity_torch.parallel import TiledInference3D

    sizes = []

    def predict(tiles):
        sizes.append(tiles.shape[0])
        return _tiles_predict(tiles)

    engine = TiledInference3D(**engine_kw, mesh=mesh)
    return engine.run(volume, predict, 3, device="cpu"), sizes


def cli_run(argv: list, arrays, valid) -> dict:
    """The training CLI's ``main(argv)`` on in-memory data: the final
    state dict."""
    from pixel_embedded_affinity_torch.train.__main__ import main

    state, _ = main(argv, data_override=(arrays, valid))
    return {k: v.clone() for k, v in state.model.state_dict().items()}


class Ranks:
    """``world`` spawned ranks running ``cases`` (:func:`rank_main`) in the
    background; :meth:`results` waits for them."""

    def __init__(self, world: int, tmp_dir, cases: dict):
        import torch.multiprocessing as mp

        self.world, self.dir = world, str(tmp_dir)
        os.makedirs(self.dir, exist_ok=True)
        torch.save(cases, os.path.join(self.dir, "cases.pt"))
        init = os.path.join(self.dir, "pg_init")
        self.ctx = mp.start_processes(_rank_entry, args=(world, self.dir, init), nprocs=world,
                                      join=False, start_method="spawn")
        self.deadline = time.monotonic() + TIMEOUT_S
        self._results = None

    def results(self) -> list:
        """Each rank's results, in rank order."""
        if self._results is None:
            try:
                while not self.ctx.join(timeout=1.0):
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"{self.world} ranks ran over {TIMEOUT_S} s")
            finally:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
            self._results = [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                                        weights_only=False) for r in range(self.world)]
        return self._results


def run_ranks(world: int, tmp_dir, cases: dict) -> list:
    """Spawn ``world`` ranks running ``cases`` and wait for their results."""
    return Ranks(world, tmp_dir, cases).results()


def _rank_entry(rank: int, world: int, tmp_dir: str, init: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    from pixel_embedded_affinity_torch.parallel.multihost import initialize

    mesh = initialize("cpu", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        cases = torch.load(os.path.join(tmp_dir, "cases.pt"), weights_only=False)
        out = rank_main(mesh, cases)
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rank_main(mesh, cases: dict) -> dict:
    """Every case on this rank. ``cases[name]["what"]``: "steps" (a step
    case, :func:`build_case`), "graphed" (a step case through the graph's
    split, :func:`graphed_steps`), "train" (:func:`train_run`), "sampler" (:func:`sampled_shards` of
    ``kind`` on ``arrays``), "tiles" (:func:`tiled_canvas` of ``volume``
    with ``engine``), "cli" (:func:`cli_run` of ``argv`` with "{rank}"
    filled in)."""
    out = {}
    for name, case in cases.items():
        what = case["what"]
        if what == "steps":
            step, state, batches = build_case(case, mesh)
            out[name] = train_steps(step, state, batches)
        elif what == "graphed":
            out[name] = graphed_steps(*build_case(case, mesh))
        elif what == "train":
            out[name] = train_run(case, mesh)
        elif what == "sampler":
            out[name] = sampled_shards(case["kind"], case["arrays"], mesh)
        elif what == "tiles":
            out[name] = tiled_canvas(case["volume"], case["engine"], mesh)
        elif what == "cli":
            argv = [a.replace("{rank}", str(mesh.rank)) for a in case["argv"]]
            out[name] = cli_run(argv, case["arrays"], case["valid"])
        else:
            raise ValueError(what)
    return out

