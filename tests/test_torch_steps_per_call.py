"""``train.steps_per_call`` in the port, on the CPU, against the JAX loop.

* The field: its default and a YAML overlay equal the JAX package's.
* The events: with S in {2, 3} and display, validation and save
  frequencies that are no multiples of S, the rounded frequencies and the
  steps at which the port's ``train()`` displays, validates and saves equal
  those of the JAX package's ``train()``. JAX's loop runs once (module
  scope) on its host path, the jitted step and scan replaced by one that
  only counts, so that it compiles in a second; its validation and
  checkpoints are recorded, not run.
* The runs: the port's S=3 training equals its S=1 training, every logged
  loss and every parameter bit for bit, in float64, on the cvppp,
  bbbc039v1 and ac3ac4 presets at filters (4, 6, 8, 12, 16) on 64x64
  (8x32x32) crops, over 7 steps (two calls and a tail of one). On the CPU
  the S=3 run takes the graph's path (prelude, static buffers, scalars
  from a tensor) with the body eager (``train/graph_step.py``).
* The optimizer: AMSGrad and SGD updates, whose scalars the step reads
  from a tensor, equal the same updates written with the scalars as
  Python floats bit for bit in float32.
* The host samplers' path (targets and EMA view built on the host) at S=2
  equals S=1; a resume at a call boundary continues the run bit for bit.

The graph itself runs on the card: ``tests/test_torch_steps_per_call_cuda.py``
and ``chip_smoke.py`` phase 26. With a data-parallel mesh:
``tests/test_torch_dp_steps_per_call.py``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_nuclei, synthesize_volume
from pixel_embedded_affinity_torch.data.cvppp import PAD, normalize_imagenet
from pixel_embedded_affinity_torch.train import (
    SGD, AMSGrad, call_freqs, latest_checkpoint, loop, make_schedule, train)

from synth import blob_labels

FILTERS = (4, 6, 8, 12, 16)
# frequencies that are no multiples of S = 2 or 3, over a run whose end is
# neither
FREQS = {"display_freq": 3, "valid_freq": 4, "save_freq": 5}
EVENT_ITERS = 11
RUN_ITERS = 7


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lab = blob_labels(50, 50, grid=3, radius=6, seed=seed + i)[:, 15:35]
        img = rng.random((50, 20, 3)).astype(np.float32) * 0.3
        img[lab > 0] += 0.5
        out.append((img, lab))
    return out


@pytest.fixture(scope="module")
def data():
    valid = [{"image": normalize_imagenet(np.pad(img, PAD + ((0, 0),), mode="reflect")),
              "seg": np.pad(lab, PAD)} for img, lab in _leaves(1, 7)]
    return {
        "cvppp": (dd.pack_cvppp_arrays(_leaves(3, 0)), valid),
        "bbbc039v1": (dd.pad_bbbc_arrays(synthesize_nuclei(2, 96, 112, seed=5), padding=30),
                      []),
        "ac3ac4": (dd.load_ac3ac4_arrays("", train_split=12, crop_z=8,
                                         arrays=synthesize_volume(14, 64, 64, n_cells=10,
                                                                  seed=1)), None),
    }


def _cfg(preset, path, **train_kw):
    data = {"crop_size": (8, 32, 32), "padding_3d": 10, "train_split": 12} \
        if preset == "ac3ac4" else {"size": 64}
    if preset == "bbbc039v1":
        data["bbbc_padding"] = 30
    return load_config(preset, {"model": {"filters": FILTERS}, "data": data,
                                "train": train_kw, "save_path": str(path)})


# ------------------------------------------------------------------ config

def test_field_default_and_overlay_match_jax(tmp_path):
    assert load_config().train.steps_per_call == jax_load_config().train.steps_per_call == 1
    path = tmp_path / "spc.yaml"
    path.write_text("train:\n  steps_per_call: 3\n  display_freq: 7\n")
    port, ref = load_config(yaml_path=str(path)), jax_load_config(yaml_path=str(path))
    assert port.train.steps_per_call == ref.train.steps_per_call == 3
    over = {"train": {"steps_per_call": 4}}
    assert (load_config("ac3ac4", overrides=over, yaml_path=str(path)).train.steps_per_call
            == jax_load_config("ac3ac4", yaml_path=str(path), overrides=over)
            .train.steps_per_call == 4)


# ------------------------------------------------------------------ events

def _jax_events(tmp_path_factory, steps_per_call):
    """JAX's train() on its host path, S = steps_per_call, the step one that
    counts; (display steps, validation steps, save steps)."""
    from pixel_embedded_affinity_tpu.train import loop as jl

    class Samples:
        def sample(self, rng):
            return {"image": np.zeros((8, 8, 3), np.float32),
                    "seg": np.zeros((8, 8), np.int32)}

    def init_state(cfg, model, tx, batch0):
        return jl.TrainState({"w": jnp.zeros(())}, {}, (), jnp.zeros((), jnp.int32))

    def make_step(*args, **kwargs):
        def step(state, batch):
            loss = jnp.sum(batch["image"]) + state.step.astype(jnp.float32) + 1.0
            return state._replace(step=state.step + 1), jnp.zeros(()), {"loss": loss}
        return step

    valid, saved = [], []
    out = tmp_path_factory.mktemp(f"jax_s{steps_per_call}")
    cfg = jax_load_config("cvppp", overrides={
        "save_path": str(out), "train": {"batch_size": 2, "num_workers": 1,
                                         "steps_per_call": steps_per_call, **FREQS}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "init_state", init_state)
        mp.setattr(jl, "make_train_step_2d", make_step)
        mp.setattr(jl, "validate_2d", lambda *a, iters=0, **k: valid.append(iters)
                   or {"valid/x": 1.0})
        mp.setattr(jl, "save_checkpoint", lambda path, state, it: saved.append(it))
        jl.train(cfg, max_iters=EVENT_ITERS, data_override=(Samples(), [0]),
                 log_dir=str(out / "log"))
    with open(out / "log" / "scalars.jsonl") as f:
        displays = [r["step"] for r in map(json.loads, f) if "loss" in r]
    return displays, valid, saved


@pytest.fixture(scope="module")
def jax_events(tmp_path_factory):
    return {s: _jax_events(tmp_path_factory, s) for s in (2, 3)}


@pytest.mark.parametrize("steps_per_call", [2, 3])
def test_events_match_the_jax_loop(jax_events, data, tmp_path, monkeypatch, steps_per_call):
    valid, saved = [], []
    monkeypatch.setattr(loop, "validate_2d", lambda *a, iters=0, **k: valid.append(iters)
                        or {"valid/x": 1.0})
    monkeypatch.setattr(loop, "save_checkpoint", lambda path, state, it: saved.append(it))
    cfg = _cfg("cvppp", tmp_path, steps_per_call=steps_per_call, **FREQS)
    state, _ = train(cfg, max_iters=EVENT_ITERS, data_override=data["cvppp"], device="cpu",
                     log_dir=str(tmp_path / "log"))
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        displays = [r["step"] for r in map(json.loads, f) if "loss" in r]
    s = steps_per_call
    assert call_freqs(cfg.train) == tuple(-(-f // s) * s for f in FREQS.values())
    assert cfg.train.display_freq == FREQS["display_freq"]  # the config is left as it is
    assert state.step == EVENT_ITERS
    assert (displays, valid, saved) == jax_events[s]


# ------------------------------------------------------------------- runs

def _float64(monkeypatch):
    """train() in float64: the model (and so the optimizer's state) and every
    floating tensor of each batch."""
    init, sampler = loop.init_state, loop.resident_sampler

    def init_state(cfg, device):
        state = init(cfg, device)
        state.model.double()
        return state

    def resident_sampler(cfg, arrays, device):
        draw = sampler(cfg, arrays, device)
        return lambda step: {k: v.double() if v.is_floating_point() else v
                             for k, v in draw(step).items()}

    monkeypatch.setattr(loop, "init_state", init_state)
    monkeypatch.setattr(loop, "resident_sampler", resident_sampler)


def _run(preset, data, path, steps, **train_kw):
    timing = {}
    cfg = _cfg(preset, path, display_freq=1, save_freq=10 ** 6, if_valid=False, **train_kw)
    state, _ = train(cfg, max_iters=steps, data_override=data, device="cpu", timing=timing)
    return state, timing


@pytest.mark.parametrize("preset", ["cvppp", "bbbc039v1", "ac3ac4"])
def test_three_steps_a_call_equal_single_steps_in_float64(data, tmp_path, monkeypatch, preset):
    _float64(monkeypatch)
    one, t1 = _run(preset, data[preset], tmp_path / "s1", RUN_ITERS)
    three, t3 = _run(preset, data[preset], tmp_path / "s3", RUN_ITERS, steps_per_call=3)
    assert one.step == three.step == RUN_ITERS and len(t1["loss"]) == RUN_ITERS
    assert t1["loss"] == t3["loss"]
    a, b = one.model.state_dict(), three.model.state_dict()
    assert next(iter(a.values())).dtype == torch.float64
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for p, q in zip(one.optimizer.state.values(), three.optimizer.state.values()):
        assert p["count"] == q["count"] == RUN_ITERS
        assert all(torch.equal(p[k], q[k]) for k in ("mu", "nu", "nu_max"))
    assert one.optimizer.count == three.optimizer.count == RUN_ITERS


def test_host_sampler_with_host_targets(tmp_path):
    """The host path: samples from the worker thread through
    ``device_prefetch``, the targets and the EMA view built on the host,
    copied into the static buffers; S=2 against S=1 over 5 steps, float32."""
    runs = []
    for spc in (1, 2):
        cfg = load_config("cvppp", {
            "model": {"filters": FILTERS},
            "data": {"size": 64, "device_resident": False, "device_gt": False,
                     "device_ema": False},
            "train": {"num_workers": 1, "display_freq": 1, "if_valid": False,
                      "steps_per_call": spc},
            "save_path": str(tmp_path / f"s{spc}")})
        train_ds, _ = loop.build_dataset(cfg, decoded=(_leaves(3, 0), []))
        timing = {}
        state, _ = train(cfg, max_iters=5, data_override=(train_ds, []), device="cpu",
                         timing=timing)
        runs.append((state.model.state_dict(), timing["loss"]))
    (a, la), (b, lb) = runs
    assert la == lb and len(la) == 5
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_at_a_call_boundary(data, tmp_path):
    full, t_full = _run("cvppp", data["cvppp"], tmp_path / "full", 6, steps_per_call=3)
    _run("cvppp", data["cvppp"], tmp_path / "split", 3, steps_per_call=3)
    assert os.path.basename(latest_checkpoint(str(tmp_path / "split" / "cvppp"))) \
        == "model-000003.ckpt"
    resumed, t_res = _run("cvppp", data["cvppp"], tmp_path / "split", 6, steps_per_call=3,
                          resume=True)
    assert resumed.step == 6 and t_res["loss"] == t_full["loss"][3:]
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        if not k.endswith("num_batches_tracked"):  # the msgpack state has no such counter
            assert torch.equal(a[k], b[k]), k


# -------------------------------------------------------------- optimizer

def float_updates(opt_type, params, grads, sched):
    """The parameters after one update for each of ``grads``, the chain
    written with its scalars as Python floats: AMSGrad (eps 0.01, weight
    decay 1e-6) or SGD (momentum 0.9, weight decay 1e-4)."""
    ps = [p.clone() for p in params]
    mu, nu, nu_max, trace = ([torch.zeros_like(p) for p in ps] for _ in range(4))
    for n, g in enumerate(grads):
        lr = float(sched(n))
        if opt_type == "sgd":
            g = torch._foreach_add(g, torch._foreach_mul(ps, 1e-4))
            torch._foreach_mul_(trace, 0.9)
            torch._foreach_add_(trace, g)
            torch._foreach_add_(ps, torch._foreach_mul(trace, -lr))
            continue
        b1, b2, c = 0.9, 0.999, np.float32(n + 1)
        g = torch._foreach_add(g, torch._foreach_mul(ps, 1e-6))
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, 0.01)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))
    return ps


@pytest.mark.parametrize("opt_type", ["adam", "sgd"])
def test_update_from_a_scalar_tensor_is_the_float_update(opt_type):
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen) for s in ((16, 3, 3, 3), (16,), (5, 7))]
    grads = [[torch.randn(p.shape, generator=gen) for p in params] for _ in range(5)]
    sched = make_schedule("poly", 1e-3, 1e-5, 1000, warmup_iters=2, decay_iters=6)
    ps = [torch.nn.Parameter(p.clone()) for p in params]
    opt = (AMSGrad(ps, eps=0.01, weight_decay=1e-6, schedule=sched) if opt_type == "adam"
           else SGD(ps, schedule=sched))
    for g in grads:
        for p, gi in zip(ps, g):
            p.grad = gi
        opt.step()
    assert [b.dtype for b in opt.scalar_buffers] == [torch.float32]
    for a, b in zip(ps, float_updates(opt_type, params, grads, sched)):
        assert torch.equal(a, b)


def test_host_counts_advance_as_a_step_does():
    p = torch.nn.Parameter(torch.ones(3))
    opt = AMSGrad([p], schedule=make_schedule("poly", 1e-3, 1e-5, 100, decay_iters=10))
    p.grad = torch.ones(3)
    opt.step()
    before = opt.host_scalars(opt.param_groups[0])
    opt.advance_host_counts()
    assert opt.count == 2 and opt.state[p]["count"] == 2
    after = opt.host_scalars(opt.param_groups[0])
    assert after["bc1"] > before["bc1"] and after["neg_lr"] != before["neg_lr"]
