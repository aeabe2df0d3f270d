"""The JAX package's train-to-quality gates, ported: the data, the configs,
a short form of each gate, and step-0 validation against JAX, on the CPU.

The gates themselves live in ``chip_smoke.py`` (``GATES``, ``gate_config``,
``gate_data``, ``run_gate``, ``gate_misses``), which runs them on the card
through the kernels; ``tools/quality_card.py`` runs them at other widths
and on the plain path. Here:

* the fixture ``tests/fixtures/quality_2d.npz`` (written by
  ``tests/make_quality_fixture.py``) equals a fresh run of JAX's two
  ``synthesize`` calls at the gates' arguments, read back with cv2, bit
  for bit; and the port reads it as it reads that folder: the same packed
  training arrays and the same validation samples;
* each gate's config holds the JAX gate's overrides field for field, but
  for the differences kept on purpose (``KEPT``);
* each gate runs 3 steps and one validation through ``train()`` on the
  CPU (the kernels' wrappers run their plain versions there), and the
  history holds the gate's keys, finite and in range; the readings held
  to the card's plain path are checked each against its tolerance, and
  the 3D gate's batch-statistics validation leaves the model as it was;
* at step 0, from the weights JAX's ``model.init`` draws at the gate's
  seed, carried across by the converter, JAX's ``validate_2d`` and the
  port's give the same SBD/DiC/VOI/ARAND on the CVPPP validation images
  and AJI on BBBC's (5e-3), and JAX's ``validate_3d`` and the port's the
  same affs_mse (1e-5) and mutex VOI (5e-3) on the gate's 20x96x96 volume;
  JAX's tiled serving is set to its float32 dense graph there, the graph
  the port serves (the JAX ac3ac4 preset serves bf16 through its folded
  graph by default: ROADMAP.md, faults section, item 4);
* marked slow, as JAX's gates are: each whole gate on the CPU, held to
  JAX's floors (``pytest -m slow tests/test_torch_quality_gate.py``).
"""

import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
pytest.importorskip("cv2")

import jax

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data.ac3ac4 import (
    AC3AC4Train as JaxAC3AC4Train, AC3AC4ValidVolume as JaxValidVolume,
    synthesize_volume as jax_synthesize_volume)
from pixel_embedded_affinity_tpu.data.bbbc import BBBCValidation as JaxBBBCValidation
from pixel_embedded_affinity_tpu.data.cvppp import CVPPPValidation as JaxCVPPPValidation
from pixel_embedded_affinity_tpu.train.loop import (
    build_model as jax_build_model, validate_2d as jax_validate_2d,
    validate_3d as jax_validate_3d)
from pixel_embedded_affinity_tpu.train.train_step import make_eval_step_2d as jax_eval_step

import chip_smoke as gates
from make_quality_fixture import FIXTURE, read_bbbc, read_cvppp, synthesize_folders
from pixel_embedded_affinity_torch.convert import (
    resunet2d_deep_from_flax, unet_pni_deep_from_flax)
from pixel_embedded_affinity_torch.data import BBBCValidation, CVPPPValidation
from pixel_embedded_affinity_torch.data.device_data import load_bbbc_arrays, load_cvppp_arrays
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep, UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.ops import multi_offset
from pixel_embedded_affinity_torch.ops.losses import CRITERIA
from pixel_embedded_affinity_torch.train import validate_2d, validate_3d, valid_geometry_3d
from pixel_embedded_affinity_torch.train.train_step import make_eval_step_2d

GATE_NAMES = list(gates.GATES)
METRIC_ATOL = 5e-3
MSE_ATOL = 1e-5
FIXTURE_MAX_BYTES = 1_500_000
# fields of the port's gate configs that differ from the JAX gates' on
# purpose: the kernels are the card's point (JAX's gates run the plain
# path because XLA on the CPU runs Pallas slowly); the data comes as arrays
# (no folder, no host sampler workers); the validation comes once after the
# last step, as in JAX; the JAX 3D gate hands train_split and padding to its
# host AC3AC4Train (test_3d_gate_trains_on_the_jax_gate_volume) where the
# port's device sampler reads them from the config; the port's 3D serving
# defaults are float32, bf16_tiled_infer off (ROADMAP.md, faults section,
# item 4)
KEPT = {"train.use_pallas", "train.num_workers", "train.valid_freq", "data.data_folder",
        "data.train_split", "data.padding_3d", "model.bf16_tiled_infer",
        "model.fast_tiled_infer"}


def _jax_gate_config(name: str):
    """The JAX gate's config, as tests/test_quality_gate.py and
    tests/test_quality_gate_bbbc3d.py build it."""
    g = gates.GATES[name]
    train = {"display_freq": 50, "valid_freq": g["steps"], "save_freq": 10 ** 9,
             "use_pallas": False, "total_iters": g["steps"], "random_seed": g["seed"]}
    if name == "ac3ac4":
        cfg = jax_load_config(name, overrides={
            "train": {**train, "batch_size": 2, "num_workers": 1, "valid_decoders": ("mutex",)},
            "data": {"crop_size": (18, 64, 64)}, "save_path": "/tmp/pea_qgate_3d"})
        cfg.model.filters = (4, 6, 8, 12, 16)
        return cfg
    cfg = jax_load_config(name, overrides={
        "data": {"data_folder": "", "size": 128},
        "train": {**train, "batch_size": 8, "num_workers": 2}})
    cfg.model.filters = (8, 12, 16, 24, 32)
    cfg.model.s2d_train = False
    return cfg


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """JAX's two synthetic datasets at the gates' arguments: {gate: folder}."""
    cv, bb = synthesize_folders(str(tmp_path_factory.mktemp("quality")))
    return {"cvppp": cv, "bbbc039v1": bb}


@pytest.mark.parametrize("name", ["cvppp", "bbbc039v1"])
def test_fixture_is_jax_synthesize(name, fixture, folders):
    fresh = (read_cvppp if name == "cvppp" else read_bbbc)(folders[name])
    prefix = "cvppp_" if name == "cvppp" else "bbbc_"
    assert set(fresh) == {k for k in fixture if k.startswith(prefix)}
    for k, v in fresh.items():
        assert v.dtype == fixture[k].dtype and v.shape == fixture[k].shape, k
        assert np.array_equal(v, fixture[k]), k
    assert os.path.getsize(FIXTURE) <= FIXTURE_MAX_BYTES


@pytest.mark.parametrize("name", ["cvppp", "bbbc039v1"])
def test_fixture_reads_as_the_folder(name, fixture, folders):
    """gate_data from the fixture against the port's readers of the folder:
    the packed training arrays and every validation sample, bit for bit."""
    cfg = gates.gate_config(name, "")
    d = cfg.data
    (images, labels), valid = gates.gate_data(cfg, fixture)
    folder = folders[name]
    if name == "cvppp":
        ref_images, ref_labels = load_cvppp_arrays(folder, d.valid_set, d.padding)
        ref_valid = CVPPPValidation(folder, valid_set=d.valid_set, padding=d.padding)
    else:
        ref_images, ref_labels = load_bbbc_arrays(folder, d.bbbc_padding)
        ref_valid = BBBCValidation(folder, shifts=d.shifts, neighbor=d.neighbor)
    for got, ref in ((images, ref_images), (labels, ref_labels)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    # CVPPP holds 2 of its 8 images out; BBBC writes 8 training and 2 more
    assert images.shape[0] == (6 if name == "cvppp" else 8)
    assert len(valid) == len(ref_valid) == gates.GATE_VALID_IMAGES
    for i in range(len(valid)):
        got, ref = valid[i], ref_valid[i]
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k == "name":
                assert got[k] is None and v == str(fixture["cvppp_valid_names"][i])
            else:
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_config_matches_jax_gate(name):
    cfg, jcfg = gates.gate_config(name, ""), _jax_gate_config(name)
    assert cfg.name == jcfg.name
    for section in ("model", "train", "data"):
        ours, theirs = getattr(cfg, section), getattr(jcfg, section)
        for f in dataclasses.fields(ours):
            if f"{section}.{f.name}" not in KEPT:
                assert getattr(ours, f.name) == getattr(theirs, f.name), f"{section}.{f.name}"
    assert cfg.train.use_pallas and cfg.train.fuse_loss and cfg.data.device_resident
    assert cfg.data.device_gt and cfg.data.device_ema
    assert cfg.train.valid_freq == cfg.train.total_iters == gates.GATES[name]["steps"]


def test_3d_gate_trains_on_the_jax_gate_volume():
    """A difference kept on purpose: JAX's 3D gate trains from a host
    AC3AC4Train (h5py, cv2), the port's from the ac3ac4 preset's device
    sampler. Both hold the same training volume, widened borders included,
    with the same margin around the crop, and validate on the same 20
    slices."""
    cfg = gates.gate_config("ac3ac4", "")
    (raw, label), valid = gates.gate_data(cfg, None)
    vol = jax_synthesize_volume(d=30, h=96, w=96, n_cells=25, seed=4321)
    host = JaxAC3AC4Train("", train_split=30, crop_size=(18, 64, 64), padding=8, arrays=vol)
    assert raw.dtype == np.uint8 and np.array_equal(raw, host.raw)
    assert label.dtype == np.int32 and np.array_equal(label, host.label)
    assert host.crop_from_origin == [cfg.data.crop_size[0],
                                     cfg.data.crop_size[1] + 2 * cfg.data.padding_3d,
                                     cfg.data.crop_size[2] + 2 * cfg.data.padding_3d]
    jvalid = JaxValidVolume("", arrays=(vol[0][:20], vol[1][:20]))
    assert np.array_equal(valid.raw, jvalid.raw) and np.array_equal(valid.label, jvalid.label)
    assert valid.raw.shape == (gates.GATE_VALID_SLICES,) + gates.GATE_VOLUME[1:]


# each gate's history keys and their ranges
RANGES = {"valid/loss": (0, np.inf), "valid/SBD": (0, 1), "valid/DiC": (0, np.inf),
          "valid/VOI": (0, np.inf), "valid/ARAND": (0, 1), "valid/AJI": (0, 1),
          "valid/F1": (0, 1), "valid/PQ": (0, 1), "valid/mutex_voi_split": (0, np.inf),
          "valid/mutex_voi_merge": (0, np.inf), "valid/mutex_voi": (0, np.inf),
          "valid/mutex_arand": (0, 1), "valid/affs_mse": (0, 1), "valid/affs_bce": (0, np.inf)}
KEYS = {"cvppp": {"valid/loss", "valid/SBD", "valid/DiC", "valid/VOI", "valid/ARAND"}}
KEYS["bbbc039v1"] = KEYS["cvppp"] | {"valid/AJI", "valid/F1", "valid/PQ"}
KEYS["ac3ac4"] = {"valid/mutex_voi_split", "valid/mutex_voi_merge", "valid/mutex_voi",
                  "valid/mutex_arand", "valid/affs_mse", "valid/affs_bce"}


@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_short_form(name, fixture, tmp_path):
    r = gates.run_gate(name, fixture, device="cpu", steps=3, out=str(tmp_path))
    print(r)
    metrics = {k: v for k, v in r.items() if k.startswith("valid/")}
    assert set(metrics) == KEYS[name]
    for k, v in metrics.items():
        lo, hi = RANGES[k]
        assert np.isfinite(v) and lo <= v + 1e-12 and v <= hi, (k, v)
    # the key JAX's 3D gate reads: the first one ending in _voi
    if name == "ac3ac4":
        assert next(k for k in r if k.endswith("_voi")) == "valid/mutex_voi"
        for k in ("affs_mse", "mutex_voi"):
            lo, hi = RANGES["valid/" + k]
            assert np.isfinite(r["batch_stats/" + k]) and lo <= r["batch_stats/" + k] <= hi
    assert set(gates.GATES[name]["card_plain"]) <= set(r)
    assert r["steps"] == 3 and r["path"] == "kernels" and r["device"] == "cpu"
    assert np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"])
    assert r["seconds"] > 0 and r["steps_per_s"] > 0
    assert sorted(os.listdir(tmp_path / "models" / name)) == ["model-000003.ckpt"]
    assert "valid/" in (tmp_path / "log" / "valid.txt").read_text()
    misses = gates.gate_misses(name, {k: np.nan for k in gates.GATES[name]["floors"]})
    assert len(misses) == len(gates.GATES[name]["floors"])


@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_off_plain_holds_each_reading(name):
    held = gates.GATES[name]["card_plain"]
    at = {k: ref for k, (ref, _) in held.items()}
    assert gates.gate_off_plain(name, at) == []
    for k, (ref, tol) in held.items():
        assert gates.gate_off_plain(name, {**at, k: ref - 0.9 * tol}) == []
        for v in (ref + 1.1 * tol, ref - 1.1 * tol, np.nan):
            assert len(gates.gate_off_plain(name, {**at, k: v})) == 1, (k, v)


def test_batch_stats_reading_leaves_the_model_as_it_was():
    """The 3D gate's batch-statistics validation neither updates the
    running statistics nor keeps the training mode or the zero momentum."""
    cfg = gates.gate_config("ac3ac4", "")
    _, valid = gates.gate_data(cfg, None)
    torch.manual_seed(cfg.train.random_seed)
    model = UNetPNIEmbeddingDeep(cfg.model.input_nc, cfg.model.filters, cfg.model.emd).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    momenta = [m.momentum for m in model.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    r = gates.batch_stats_reading(cfg, model, valid)
    assert set(r) == {"batch_stats/affs_mse", "batch_stats/mutex_voi"}
    assert all(np.isfinite(v) for v in r.values())
    assert not model.training
    assert [m.momentum for m in model.modules()
            if isinstance(m, torch.nn.BatchNorm3d)] == momenta
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the running statistics (all at their init here) give another reading
    ours = validate_3d(cfg, types.SimpleNamespace(model=model), valid, "cpu")
    assert ours["valid/affs_mse"] != r["batch_stats/affs_mse"]


def _jax_init(model, x, seed):
    return jax.device_get(jax.jit(lambda v: model.init(jax.random.PRNGKey(seed), v,
                                                       train=False))(x))


@pytest.mark.parametrize("name", ["cvppp", "bbbc039v1"])
def test_step0_validation_2d_matches_jax(name, fixture, folders):
    cfg, jcfg = gates.gate_config(name, ""), _jax_gate_config(name)
    offsets = multi_offset(list(cfg.data.shifts), neighbor=cfg.data.neighbor)
    jmodel = jax_build_model(jcfg)
    variables = _jax_init(jmodel, np.zeros((1, 128, 128, 3), np.float32), cfg.train.random_seed)
    jds = (JaxCVPPPValidation(folders[name], shifts=tuple(jcfg.data.shifts),
                              neighbor=jcfg.data.neighbor, valid_set=jcfg.data.valid_set)
           if name == "cvppp" else
           JaxBBBCValidation(folders[name], shifts=tuple(jcfg.data.shifts),
                             neighbor=jcfg.data.neighbor))
    theirs = jax_validate_2d(
        jcfg, jax.jit(jax_eval_step(jmodel, offsets, use_pallas=False)),
        types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"]),
        jds, offsets)

    model = ResidualUNet2DDeep(cfg.model.input_nc, cfg.model.output_nc, cfg.model.filters,
                               cfg.model.emd)
    model.load_state_dict(resunet2d_deep_from_flax(variables))
    _, valid = gates.gate_data(cfg, fixture)
    ours = validate_2d(cfg, make_eval_step_2d(offsets, criterion=CRITERIA[cfg.train.loss_func]),
                       types.SimpleNamespace(model=model), valid, offsets, "cpu")
    assert set(ours) == set(theirs) == KEYS[name]
    keys = ["valid/SBD", "valid/DiC", "valid/VOI", "valid/ARAND"]
    if name == "bbbc039v1":
        keys.append("valid/AJI")
    for k in keys:
        np.testing.assert_allclose(ours[k], theirs[k], atol=METRIC_ATOL, err_msg=k)
    np.testing.assert_allclose(ours["valid/loss"], theirs["valid/loss"], rtol=1e-4)


def test_step0_validation_3d_matches_jax():
    cfg, jcfg = gates.gate_config("ac3ac4", ""), _jax_gate_config("ac3ac4")
    jcfg.model.dtype = "float32"
    jcfg.model.bf16_tiled_infer = False
    jcfg.model.fast_tiled_infer = False
    jmodel = jax_build_model(jcfg)
    variables = _jax_init(jmodel, np.zeros((1,) + tuple(cfg.data.crop_size) + (1,), np.float32),
                          cfg.train.random_seed)
    _, valid = gates.gate_data(cfg, None)
    raw, label = jax_synthesize_volume(d=30, h=96, w=96, n_cells=25, seed=4321)
    stride, padding = valid_geometry_3d(cfg.data.crop_size)
    theirs = jax_validate_3d(
        jcfg, jmodel, types.SimpleNamespace(params=variables["params"],
                                            batch_stats=variables["batch_stats"]),
        JaxValidVolume("", arrays=(raw[:20], label[:20])),
        decoders=("mutex",), crop_size=tuple(cfg.data.crop_size), stride=stride,
        padding=padding)

    model = UNetPNIEmbeddingDeep(cfg.model.input_nc, cfg.model.filters, cfg.model.emd)
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    ours = validate_3d(cfg, types.SimpleNamespace(model=model), valid, "cpu")
    assert set(ours) == set(theirs) == KEYS["ac3ac4"]
    np.testing.assert_allclose(ours["valid/affs_mse"], theirs["valid/affs_mse"], atol=MSE_ATOL)
    np.testing.assert_allclose(ours["valid/mutex_voi"], theirs["valid/mutex_voi"],
                               atol=METRIC_ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("name", GATE_NAMES)
def test_gate_reaches_jax_floor_on_cpu(name, fixture, tmp_path):
    r = gates.run_gate(name, fixture, device="cpu", out=str(tmp_path))
    print(r)
    assert not gates.gate_misses(name, r)
