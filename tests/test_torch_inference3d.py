"""The port's AC3/AC4 3D serving path vs the JAX package's, end to end on
the CPU: the tiled forward's canvas, the three decoders' segmentations and
their VOI/ARAND, the volume reader's split rules, and the CLI on a JAX
msgpack checkpoint. Both packages get the same synthetic volume and the same
weights (Flax variables drawn from a seeded numpy generator and carried
across by ``unet_pni_deep_from_flax``), at narrow widths.
"""

import os
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

import jax

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data.ac3ac4 import (
    AC3AC4ValidVolume as JaxValidVolume, synthesize_volume as jax_synthesize_volume)
from pixel_embedded_affinity_tpu.infer.inference3d import (
    run_inference_3d as jax_run_inference_3d)
from pixel_embedded_affinity_tpu.train.checkpoint import save_checkpoint
from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model

from pixel_embedded_affinity_torch import inference as cli
from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.data import (
    AC3AC4ValidVolume, label_affinities, synthesize_volume)
from pixel_embedded_affinity_torch.infer import run_inference_3d

FILTERS = (4, 6, 8, 12, 16)
DECODERS = ("mutex", "waterz", "lmc")
GEOMETRY = dict(crop_size=(18, 64, 64), stride=(10, 32, 32), padding=(2, 8, 8),
                batch_size=4)
# The canvases agree to ~1e-6 (f32 convs summed in another order). The
# decoders sort or threshold affinities, so a difference that large could
# move a voxel between segments; none moved here (segmentations bit-equal),
# and the metric bound allows a handful of moved voxels. Random weights give
# smooth embeddings whose neighbour affinities sit near 1, so there each
# decoder finds one segment; test_decoders_match_jax holds the decoders to
# the JAX package's on a canvas with tens of segments.
CANVAS_ATOL = 1e-4
METRIC_ATOL = 5e-3


def _draw_variables(seed: int):
    model = jax_build_model(_jax_cfg())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 18, 64, 64, 1), np.float32), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.3 if "kernel" in name else 0.1
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_cfg(folder: str | None = None):
    """The JAX ac3ac4 preset in float32 on its dense graph, as the port serves."""
    over = {"data": {"data_folder": folder}} if folder else None
    cfg = jax_load_config("ac3ac4", overrides=over)
    cfg.model.filters = FILTERS
    cfg.model.dtype = "float32"
    cfg.model.bf16_tiled_infer = False
    cfg.model.fast_tiled_infer = False
    return cfg


@pytest.fixture(scope="module")
def case():
    raw, label = jax_synthesize_volume(d=24, h=96, w=96)
    variables = _draw_variables(0)
    return dict(vol=raw.astype(np.float32) / 255.0, label=label, variables=variables,
                sd=unet_pni_deep_from_flax(variables),
                cfg=load_config("ac3ac4", {"model": {"filters": FILTERS}}))


@pytest.fixture(scope="module")
def jax_run(case):
    timing = {}
    affs, results = jax_run_inference_3d(
        _jax_cfg(), case["variables"], case["vol"], gt=case["label"], decoders=DECODERS,
        use_pallas=False, timing=timing, **GEOMETRY)
    return affs, results, timing


def test_serving_3d_matches_jax(case, jax_run):
    jaffs, jresults, jtiming = jax_run
    timing = {}
    affs, results = run_inference_3d(case["cfg"], case["sd"], case["vol"], gt=case["label"],
                                     decoders=DECODERS, timing=timing, device="cpu",
                                     **GEOMETRY)
    assert affs.shape == jaffs.shape == (12, 24, 96, 96) and affs.dtype == np.float32
    np.testing.assert_allclose(affs, jaffs, atol=CANVAS_ATOL)
    for dec in DECODERS:
        seg, m = results[dec]
        jseg, jm = jresults[dec]
        assert seg.dtype == jseg.dtype and seg.shape == jseg.shape
        assert np.array_equal(seg, jseg), dec
        assert set(m) == set(jm) == {"voi_split", "voi_merge", "voi", "arand"}
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], atol=METRIC_ATOL, err_msg=f"{dec} {k}")
    assert set(jtiming) <= set(timing)
    assert set(timing["decode_s"]) == set(jtiming["decode_s"]) == set(DECODERS)
    assert timing["forward_s"] + sum(timing["decode_s"].values()) <= timing["total_s"]


def test_decoders_match_jax():
    """The three decoders as run_inference_3d calls them, in both packages,
    on a noisy label-derived canvas of the synthetic volume."""
    from pixel_embedded_affinity_tpu.ops.affinity_np import relabel as jax_relabel
    from pixel_embedded_affinity_tpu.ops.offsets import offsets_3d as jax_offsets_3d
    from pixel_embedded_affinity_tpu.postproc import mc_baseline as jax_mc, seg_mutex
    from pixel_embedded_affinity_tpu.postproc.agglomerate import agglomerate
    from pixel_embedded_affinity_tpu.postproc.watershed import watershed_from_affs

    from pixel_embedded_affinity_torch.infer import decode

    _, label = jax_synthesize_volume(d=12, h=80, w=72, n_cells=30, seed=5)
    affs = label_affinities(label, 0)
    jax_decoders = {
        "mutex": lambda a: seg_mutex(a, offsets=jax_offsets_3d(),
                                     strides=[1, 10, 10]).astype(np.uint64),
        "waterz": lambda a: agglomerate(a[:3], watershed_from_affs(a[:3]), threshold=0.5),
        "lmc": lambda a: jax_mc(a[:3])}
    for dec, fn in jax_decoders.items():
        exp = jax_relabel(fn(affs).astype(np.int64))
        got = decode(affs, dec)
        assert got.dtype == exp.dtype and np.array_equal(got, exp), dec
        assert len(np.unique(got)) >= 10, (dec, len(np.unique(got)))


def test_bf16_tiled_infer_served(case):
    """bf16_tiled_infer serves: a float32 canvas of the volume's shape, off
    the float32 serve by bfloat16's rounding (tests/test_torch_bf16.py
    holds it to the float32 canvas and JAX's at the JAX package's bar)."""
    cfg = load_config("ac3ac4", {"model": {"filters": FILTERS, "bf16_tiled_infer": True}})
    got, _ = run_inference_3d(cfg, case["sd"], case["vol"], decoders=(), device="cpu",
                              **GEOMETRY)
    ref, _ = run_inference_3d(load_config("ac3ac4", {"model": {"filters": FILTERS}}),
                              case["sd"], case["vol"], decoders=(), device="cpu", **GEOMETRY)
    assert got.dtype == np.float32 and got.shape == ref.shape == (12,) + case["vol"].shape
    assert 0 < np.abs(got - ref).max() <= 0.05


def test_synthesize_volume_matches_jax():
    for got, exp in zip(synthesize_volume(d=6, h=40, w=36, n_cells=9, seed=3),
                        jax_synthesize_volume(d=6, h=40, w=36, n_cells=9, seed=3)):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("dataset_name,mode,depth", [
    ("ac4", "valid", 20),        # the validation split: the last 20 slices
    ("ac4", "validation", 120),  # any other mode: the whole volume
    ("ac3", "test", 100),        # AC3: the first 100 slices
])
def test_valid_volume_matches_jax(dataset_name, mode, depth):
    rng = np.random.default_rng(4)
    arrays = (rng.integers(0, 256, (120, 8, 9), dtype=np.uint8),
              rng.integers(0, 50, (120, 8, 9)).astype(np.uint32))
    ours = AC3AC4ValidVolume("", dataset_name, mode, arrays=arrays)
    theirs = JaxValidVolume("", dataset_name, mode, arrays=arrays)
    assert ours.raw.shape[0] == depth
    for a, b in ((ours.raw, theirs.raw), (ours.label, theirs.label)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cli_3d_on_a_jax_checkpoint(case, tmp_path, capsys):
    """The CLI serves an AC4 volume read from h5 files with a JAX msgpack
    checkpoint, at the preset's serving geometry, and prints what
    run_inference_3d gives for the same weights."""
    raw, label = synthesize_volume(d=20, h=100, w=100, n_cells=12, seed=1)
    folder = tmp_path / "AC3AC4"
    folder.mkdir()
    for name, arr in (("AC4_inputs.h5", raw), ("AC4_labels.h5", label)):
        with h5py.File(folder / name, "w") as f:
            f.create_dataset("main", data=arr)
    state = {"params": case["variables"]["params"],
             "batch_stats": case["variables"]["batch_stats"], "step": 3}
    fname = save_checkpoint(str(tmp_path / "models"), state, 3)
    cli.main(["-c", "ac3ac4", "-ck", fname, "--device", "cpu", "--decoders", "mutex,lmc",
              "-o", f"data.data_folder={folder}", f"model.filters={FILTERS}"])
    lines = capsys.readouterr().out.strip().splitlines()
    printed = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1]) for ln in lines[:2]}
    timing = json.loads(lines[2].split(":", 1)[1])
    assert set(printed) == {"mutex", "lmc"} and set(timing["decode_s"]) == {"mutex", "lmc"}
    _, results = run_inference_3d(case["cfg"], case["sd"], raw.astype(np.float32) / 255.0,
                                  gt=label.astype(np.int64), decoders=("mutex", "lmc"),
                                  device="cpu")
    for dec, (_, m) in results.items():
        assert printed[dec] == m, dec
