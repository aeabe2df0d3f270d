"""The port's CVPPP serving path vs the JAX package's, end to end on the CPU.

Both packages get the same sample list (built by the JAX package's
``synthesize`` + ``CVPPPValidation``) and the same weights (Flax variables
carried across by ``resunet2d_deep_from_flax``), at narrow widths.
"""

import os

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
from pixel_embedded_affinity_tpu.data.cvppp import (
    CVPPPTest as JaxCVPPPTest, CVPPPValidation as JaxCVPPPValidation, synthesize)
from pixel_embedded_affinity_tpu.infer.inference2d import (
    run_cvppp_test as jax_run_cvppp_test, run_inference_2d as jax_run_inference_2d)
from pixel_embedded_affinity_tpu.train.checkpoint import save_checkpoint
from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model

from pixel_embedded_affinity_torch import inference as cli
from pixel_embedded_affinity_torch.checkpoint import load_jax_checkpoint
from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import resunet2d_deep_from_flax
from pixel_embedded_affinity_torch.data import CVPPPTest, CVPPPValidation
from pixel_embedded_affinity_torch.infer import run_cvppp_test, run_inference_2d

FILTERS = (4, 6, 8, 12, 16)
# Metric tolerance. The affinities agree to ~1e-6 (f32 convs summed in
# another order); mutex watershed sorts edges by weight, so a difference
# that large can swap two nearly tied edges and move single pixels between
# segments. Measured at these widths on 15 synthetic images (3 seeds of
# this set): affinities within 1.6e-6, segmentations bit-equal, every
# metric equal (max difference 0). The bound allows a handful of moved
# pixels out of 144*160, which shift SBD/ARAND by ~1e-4 each and VOI by a
# few 1e-4, but no change in the number of segments (DiC is an integer).
METRIC_ATOL = 5e-3


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvppp")
    folder = str(root / "CVPPP")
    synthesize(folder, n_train=4, n_valid=3, n_test=2, h=130, w=116)
    jcfg = jax_load_config("cvppp", overrides={"data": {"data_folder": folder}})
    jcfg.model.filters = FILTERS
    jcfg.model.s2d_train = False
    jcfg.model.dtype = "float32"
    valid = JaxCVPPPValidation(folder, shifts=tuple(jcfg.data.shifts),
                               neighbor=jcfg.data.neighbor)
    samples = [valid[i] for i in range(len(valid))]
    h, w = samples[0]["image"].shape[:2]
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, h, w, 3), np.float32), train=False))

    def draw(path, leaf):
        if "'var'" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    cfg = load_config("cvppp", overrides={"data": {"data_folder": folder},
                                          "model": {"filters": FILTERS}})
    return dict(root=root, folder=folder, jcfg=jcfg, cfg=cfg, samples=samples,
                variables=variables, sd=resunet2d_deep_from_flax(variables))


@pytest.fixture(scope="module")
def jax_run(case):
    out = case["root"] / "jax"
    per, agg = jax_run_inference_2d(case["jcfg"], case["variables"],
                                    case["samples"], out_dir=str(out),
                                    save_h5=True, use_pallas=False,
                                    one_dispatch=False)
    return out, per, agg


@pytest.mark.parametrize("batch_size", [1, 2])
def test_serving_matches_jax(case, jax_run, batch_size):
    jout, jper, jagg = jax_run
    out = case["root"] / f"torch_b{batch_size}"
    timing = {}
    per, agg = run_inference_2d(case["cfg"], case["sd"], case["samples"],
                                out_dir=str(out), timing=timing,
                                batch_size=batch_size, device="cpu")
    with h5py.File(out / "affs.hdf") as ft, h5py.File(jout / "affs.hdf") as fj:
        np.testing.assert_allclose(ft["main"][:], fj["main"][:], atol=1e-4)
    assert len(per) == len(jper) == 3
    for t, j in zip(per, jper):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], atol=METRIC_ATOL, err_msg=k)
    for k in jagg:
        np.testing.assert_allclose(agg[k], jagg[k], atol=METRIC_ATOL, err_msg=k)
    assert timing["n_images"] == 3
    assert {"total_s", "setup_s", "forward_s", "decode_s", "metrics_s"} <= set(timing)
    assert timing["setup_s"] + timing["forward_s"] <= timing["total_s"]


def test_port_dataset_matches_jax(case):
    ours = CVPPPValidation(case["folder"])
    assert len(ours) == len(case["samples"])
    for i, s in enumerate(case["samples"]):
        np.testing.assert_array_equal(ours[i]["image"], s["image"])
        np.testing.assert_array_equal(ours[i]["seg"], s["seg"])
    theirs = JaxCVPPPTest(case["folder"])
    for i, s in enumerate(CVPPPTest(case["folder"])):
        if i == len(theirs):
            break
        np.testing.assert_array_equal(s["image"], theirs[i]["image"])
        np.testing.assert_array_equal(s["fg"], theirs[i]["fg"])
        assert s["name"] == theirs[i]["name"]


def test_cvppp_submission_matches_jax(case):
    jpath = str(case["root"] / "sub_jax.h5")
    tpath = str(case["root"] / "sub_torch.h5")
    jax_run_cvppp_test(case["jcfg"], case["variables"],
                       JaxCVPPPTest(case["folder"]), jpath, use_pallas=False,
                       one_dispatch=False)
    _, names = run_cvppp_test(case["cfg"], case["sd"], CVPPPTest(case["folder"]),
                              tpath, device="cpu")
    assert len(names) == 2
    with h5py.File(tpath) as ft, h5py.File(jpath) as fj:
        keys = []
        fj.visit(keys.append)
        got = []
        ft.visit(got.append)
        assert got == keys
        for name in names:
            a, b = ft[f"A1/{name}/label"], fj[f"A1/{name}/label"]
            assert a.dtype == b.dtype and a.shape == b.shape == (130, 116)
            assert a[:].tobytes() == b[:].tobytes()


def test_load_jax_checkpoint_and_cli(case, jax_run, capsys):
    ck_dir = str(case["root"] / "models")
    state = {"params": case["variables"]["params"],
             "batch_stats": case["variables"]["batch_stats"], "step": 7}
    fname = save_checkpoint(ck_dir, state, 7)
    restored = load_jax_checkpoint(fname)
    assert int(restored["step"]) == 7
    flat_a = jax.tree_util.tree_leaves_with_path(case["variables"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        {"params": restored["params"], "batch_stats": restored["batch_stats"]}))
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)

    cli.main(["-c", "cvppp", "-ck", fname, "--device", "cpu", "-o",
              f"data.data_folder={case['folder']}",
              f"model.filters={FILTERS}"])
    import json

    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k, v in jax_run[2].items():
        np.testing.assert_allclose(agg[k], v, atol=METRIC_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_fast_run(case):
    out = case["root"] / "jax_fast"
    per, agg = jax_run_inference_2d(case["jcfg"], case["variables"], case["samples"],
                                    out_dir=str(out), save_h5=True, use_pallas=True,
                                    one_dispatch=False)
    return out, per, agg


@pytest.mark.parametrize("batch_size", [1, 2])
def test_fast_serving_matches_jax(case, jax_fast_run, batch_size):
    """use_fast=True (the folded-BatchNorm fast forward on the host-packed
    s2d image, head at full resolution) against JAX's use_pallas=True
    serving, which on the CPU runs the same fast forward and its pure-XLA
    small-batch affinity: affinities to 1e-4, metrics to METRIC_ATOL,
    segmentations bit-equal."""
    jout, jper, jagg = jax_fast_run
    out = case["root"] / f"torch_fast_b{batch_size}"
    per, agg = run_inference_2d(case["cfg"], case["sd"], case["samples"], out_dir=str(out),
                                batch_size=batch_size, device="cpu", use_fast=True)
    with h5py.File(out / "affs.hdf") as ft, h5py.File(jout / "affs.hdf") as fj:
        np.testing.assert_allclose(ft["main"][:], fj["main"][:], atol=1e-4)
    with h5py.File(out / "seg.hdf") as ft, h5py.File(jout / "seg.hdf") as fj:
        assert ft["main"][:].tobytes() == fj["main"][:].tobytes()
    assert len(per) == len(jper) == 3
    for t, j in zip(per, jper):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], atol=METRIC_ATOL, err_msg=k)
    for k in jagg:
        np.testing.assert_allclose(agg[k], jagg[k], atol=METRIC_ATOL, err_msg=k)



def test_cli_fast_matches_jax(case, jax_fast_run, capsys):
    """The serving CLI with --fast: the fast forward from a JAX checkpoint,
    metrics to METRIC_ATOL of JAX's use_pallas=True serving."""
    import json

    fname = save_checkpoint(str(case["root"] / "models_fast"),
                            {"params": case["variables"]["params"],
                             "batch_stats": case["variables"]["batch_stats"], "step": 3}, 3)
    cli.main(["-c", "cvppp", "-ck", fname, "--device", "cpu", "--fast", "-o",
              f"data.data_folder={case['folder']}", f"model.filters={FILTERS}"])
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k, v in jax_fast_run[2].items():
        np.testing.assert_allclose(agg[k], v, atol=METRIC_ATOL, err_msg=k)

def _leaves(h, w, seed):
    """A labelled sample of h x w: rectangles of leaves on a dark ground,
    ImageNet-normalised-like values."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((h, w), np.uint16)
    for i in range(1, 7):
        y0, x0 = rng.integers(0, h - h // 4), rng.integers(0, w - w // 4)
        seg[y0:y0 + rng.integers(h // 8, h // 4), x0:x0 + rng.integers(w // 8, w // 4)] = i
    img = rng.normal(0, 0.2, (h, w, 3)).astype(np.float32)
    img[seg > 0] += rng.uniform(0.5, 1.5, 3).astype(np.float32)
    return {"image": img, "seg": seg}


def test_ragged_image_shapes_serve_as_jax(case, monkeypatch):
    """A 544x544 image, then a 64x80 one: the server's default batch (4 at
    544x544) ends where the shape changes. Metrics to METRIC_ATOL of JAX's
    per-image serving, segmentations bit-equal."""
    import pixel_embedded_affinity_tpu.infer.inference2d as jinf

    import pixel_embedded_affinity_torch.infer.inference2d as tinf

    samples = [_leaves(544, 544, 1), _leaves(64, 80, 2)]
    segs = {"jax": [], "torch": []}
    for mod, key in ((jinf, "jax"), (tinf, "torch")):
        real = mod.relabel
        monkeypatch.setattr(mod, "relabel", lambda seg, _r=real, _k=key: segs[_k].append(
            _r(seg)) or segs[_k][-1])
    jper, jagg = jax_run_inference_2d(case["jcfg"], case["variables"], samples,
                                      use_pallas=False, one_dispatch=False)
    timing = {}
    per, agg = run_inference_2d(case["cfg"], case["sd"], samples, timing=timing, device="cpu")
    assert timing["n_images"] == 2 and len(per) == len(jper) == 2
    assert [s.shape for s in segs["torch"]] == [(544, 544), (64, 80)]
    for a, b in zip(segs["torch"], segs["jax"]):
        assert a.astype(np.uint16).tobytes() == b.astype(np.uint16).tobytes()
    for t, j in zip(per, jper):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], atol=METRIC_ATOL, err_msg=k)
