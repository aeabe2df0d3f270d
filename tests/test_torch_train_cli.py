"""The port's training command line and YAML overlays, on the CPU.

``load_config(yaml_path=...)`` against the JAX package's on every field
the port has, alone and between a preset and overrides (JAX's order:
preset, YAML, overrides). ``python -m pixel_embedded_affinity_torch.train``
(driven in-process through ``main``) trains 2 steps with ``--device cpu``
on a folder the JAX package's ``synthesize`` wrote (cv2 reads it here),
from the host sampler with host-built targets and EMA views, at a poly
schedule from a YAML file; writes a msgpack checkpoint; and a second run
with ``train.resume=True`` resumes from it and validates. ``--device``
defaults to CUDA, which raises without a card (``--distributed`` is
tested in tests/test_torch_parallel.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data.cvppp import synthesize

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.train.__main__ import main
from pixel_embedded_affinity_torch.train.optim import make_schedule

OVERLAY = """# an overlay of the kinds of YAML a config file uses
name: cli_run
train:
  lr_mode: poly          # the schedule
  warmup_iters: 2
  decay_iters: 10
  end_lr: 1.0e-6
  base_lr: 0.0001
  opt_type: 'adam'
  valid_decoders: [waterz, "mutex"]
data:
  shifts:
    - 1
    - 3
    - 5
    - 9
    - 27
  crop_size: [8, 32, 32]
  if_ema_noise: yes
model:
  filters: [4, 6, 8, 12, 16]
"""


def _fields(cfg):
    return {sec: dataclasses.asdict(getattr(cfg, sec)) for sec in ("model", "train", "data")}


# the TPU's 3D serving choices: off by default in the port, on in JAX
# (ROADMAP.md, differences kept on purpose, item 4)
TPU_DEFAULTS = ("bf16_tiled_infer", "fast_tiled_infer")


def _same_as_jax(port, ref):
    assert port.name == ref.name and port.save_path == ref.save_path
    n = 0
    for sec, fields in _fields(port).items():
        r = getattr(ref, sec)
        for k, v in fields.items():
            if k in TPU_DEFAULTS:
                assert not v and getattr(r, k), f"{sec}.{k}"
                continue
            assert v == getattr(r, k), f"{sec}.{k}: {v!r} != {getattr(r, k)!r}"
            n += 1
    return n


@pytest.fixture(scope="module")
def overlay(tmp_path_factory):
    path = tmp_path_factory.mktemp("yaml") / "overlay.yaml"
    path.write_text(OVERLAY)
    return str(path)


def test_yaml_overlay_matches_jax(overlay):
    assert _same_as_jax(load_config(yaml_path=overlay), jax_load_config(yaml_path=overlay)) >= 40
    over = {"train": {"batch_size": 4}, "data": {"shifts": (1, 3)}}
    port = load_config("ac3ac4", overrides=over, yaml_path=overlay)
    ref = jax_load_config("ac3ac4", yaml_path=overlay, overrides=over)
    _same_as_jax(port, ref)
    assert port.data.shifts == (1, 3) and port.train.lr_mode == "poly"
    assert port.model.filters == (4, 6, 8, 12, 16) and port.data.crop_size == (8, 32, 32)


def test_yaml_unknown_key_raises_as_in_jax(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("train:\n  steps_per_epoch: 3\n")
    with pytest.raises(KeyError, match="TrainConfig.steps_per_epoch"):
        load_config(yaml_path=str(path))
    with pytest.raises(KeyError, match="TrainConfig.steps_per_epoch"):
        jax_load_config(yaml_path=str(path))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("cvppp")
    synthesize(str(d), n_train=4, n_valid=1, h=66, w=50, seed=3)
    return str(d)


def _argv(overlay, folder, save, iters, *extra):
    """-c the YAML (over the defaults, as JAX reads it) with the cvppp
    preset's data keys and the host sampler as overrides."""
    return ["-c", overlay, "-i", str(iters), "--device", "cpu", "-o",
            f"data.data_folder={folder}", "data.size=64", "data.device_resident=False",
            "data.device_gt=False", "data.device_ema=False", f"save_path={save}",
            "train.display_freq=1", "train.valid_freq=3", "train.save_freq=2",
            "train.num_workers=1", *extra]


def test_cli_trains_from_the_host_sampler_and_resumes(overlay, folder, tmp_path):
    state, history = main(_argv(overlay, folder, tmp_path, 2))
    assert state.step == 2 and history == []
    run = tmp_path / "cli_run"
    assert sorted(os.listdir(run)) == ["log", "model-000002.ckpt"]
    with open(run / "model-000002.ckpt", "rb") as f:
        assert f.read(1)[0] & 0xF0 == 0x80  # msgpack, not torch.save's zip
    state, history = main(_argv(overlay, folder, tmp_path, 3, "train.resume=True"))
    assert state.step == 3 and state.optimizer.count == 3
    assert len(history) == 1 and all(np.isfinite(v) for v in history[0].values())
    with open(run / "log" / "scalars.jsonl") as f:
        logged = [json.loads(ln) for ln in f if '"lr"' in ln]
    sched = make_schedule("poly", 1e-4, 1e-6, 200000, 2, 10, 1.5)
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert [r["lr"] for r in logged] == [sched(0), sched(1), sched(2)]
    assert all(np.isfinite(r["loss"]) for r in logged)


def test_cli_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", "cvppp", "-i", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-c", "cvppp_resnet50", "-i", "1"])
    # the 3D serving graph and the tiled engine default to CUDA too
    from pixel_embedded_affinity_torch.infer import build_model, run_inference_3d
    from pixel_embedded_affinity_torch.parallel import TiledInference3D

    vol = np.zeros((20, 64, 64), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference_3d(load_config("ac3ac4"), None, vol, decoders=())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TiledInference3D().run(vol, lambda t: t, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(load_config("cvppp_resnet101"))
