"""int8 serving: the port's ``ops/quant.py``, the int8 options of
``models/fast_forward.py`` and ``model.int8_infer`` in
``run_inference_2d``, against the JAX package's on the CPU.

* The quantizers give JAX's int8 codes exactly, at .5 ties (both round half
  to even) and past saturation; ``act_scale_from_absmax`` is the same
  float.
* ``conv_i8``'s plain version (F.conv2d in float64 on the int8 values)
  gives JAX's int32 accumulators exactly at the three paddings the fast
  forward uses, and its float32 output within 1e-6 relative.
* Calibration: the same sites (split blocks' "c1b" too) and values within
  1e-5 relative, by max and by the 0.999 quantile.
* The int8 fast forward fed JAX's ranges: embedding cosine >= 0.9999 and
  max |d| <= 2e-3 against JAX's int8 forward; and JAX's own bars
  (``tests/test_int8_quant.py``) against the float32 forward on the
  committed fixture's weights: cosine > 0.99, affinity max |d| < 0.05,
  mean < 0.005.
* Serving with ``model.int8_infer`` against JAX's one-dispatch int8
  serving: metrics within 5e-3.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.models import ResidualUNet2DDeep as JaxResUNet
from pixel_embedded_affinity_tpu.models import fast_forward as jff
from pixel_embedded_affinity_tpu.ops import quant as jq

from pixel_embedded_affinity_torch.convert import resunet2d_deep_from_flax
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.models import fast_forward as ff
from pixel_embedded_affinity_torch.ops import quant
from pixel_embedded_affinity_torch.ops.conv_i8_cuda import (conv_i8_acc, conv_i8_acc_plain,
                                                            conv_i8_plain, pack_weights_i8,
                                                            quantize_act_plain)

FILTERS = (4, 6, 8, 12, 16)
EMD = 16
# the three conv forms of the fast forward, (top, bottom, left, right), and
# the JAX conv partial of each
PADDINGS = {"3x3 SAME": ((1, 1, 1, 1), jff._conv, 3),
            "2x2 qx=0": ((1, 1, 1, 0), jff._conv2x2_x0, 2),
            "2x2 qx=1": ((1, 1, 0, 1), jff._conv2x2_x1, 2)}
CALIB_RTOL = 1e-5


def _draw(rng):
    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "'var'" in key:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "'kernel'" in key:
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(
                np.float32)
        if "'scale'" in key:
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    return draw


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    jmodel = JaxResUNet(out_channels=2, nfeatures=FILTERS, emd=EMD)
    x = rng.normal(size=(2, 64, 48, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    model = ResidualUNet2DDeep(3, 2, FILTERS, EMD)
    model.load_state_dict(resunet2d_deep_from_flax(variables))
    return dict(variables=variables, model=model.eval(), x=x)


# ---------------------------------------------------------------- quantizers

def _weights_with_ties():
    """(3, 3, 4, 5) float32 weights: columns whose scale is exactly 1 or
    0.25 with values on .5 ties, a zero column, and random ones."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32)
    col0 = rng.choice(ties, size=(3, 3, 4)).astype(np.float32)
    col0[0, 0, 0] = 127.0                      # absmax 127: scale 1
    w[..., 0] = col0
    w[..., 1] = col0 * np.float32(0.25)        # scale 0.25
    w[..., 2] = 0.0                            # absmax 0: scale 1e-12 / 127
    return w


def test_quantize_weights_per_cout_matches_jax():
    w = _weights_with_ties()
    jw, js = jq.quantize_weights_per_cout(jnp.asarray(w))
    tw, ts = quant.quantize_weights_per_cout(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    # the ties went to even codes
    assert set(np.unique(tw.numpy()[..., 0])) <= {0, 2, -2, 126, -126, 127}


@pytest.mark.parametrize("absmax", [2.54, 1.0, 0.0, 1e-20, 63.5])
def test_act_scale_from_absmax_matches_jax(absmax):
    assert quant.act_scale_from_absmax(absmax) == jq.act_scale_from_absmax(absmax)
    assert quant.act_scale_from_absmax(np.float32(absmax)) == jq.act_scale_from_absmax(
        np.float32(absmax))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.5, 2.0 / 127.0, jq.act_scale_from_absmax(2.54)])
def test_quantize_act_matches_jax(scale, dtype):
    """Ties at .5 (exact with scale 0.5: x = k / 2 + 1 / 4), values past
    saturation and random ones; float32 and bfloat16 inputs."""
    rng = np.random.default_rng(2)
    x = np.concatenate([np.arange(-70, 70, dtype=np.float32) * 0.5 + 0.25,
                        np.array([0.0, -0.0, 99.0, -99.0, 1e4, -1e4], np.float32),
                        rng.normal(scale=1.5, size=494).astype(np.float32)]).reshape(2, -1, 4)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jq.quantize_act(jx, scale))
    got = quant.quantize_act(tx, scale)
    assert got.dtype == torch.int8 and got.shape == tx.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(quantize_act_plain(tx, scale).numpy(), want)
    assert got.numpy().max() == 127 and got.numpy().min() == -127


# ---------------------------------------------------------------- conv_i8

def _int8(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, size=shape).astype(np.int8)


@pytest.mark.parametrize("shift", [False, True], ids=["no shift", "shift"])
@pytest.mark.parametrize("form", list(PADDINGS))
def test_conv_i8_plain_matches_jax(form, shift):
    padding, jconv, k = PADDINGS[form]
    rng = np.random.default_rng(3)
    cin, cout = 24, 10
    xq = _int8(rng, (2, 9, 11, cin))
    wq = _int8(rng, (k, k, cin, cout))
    xq[0, 0, 0] = 127                                   # saturated codes
    wq[..., 0] = -127
    os_ = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    sh = rng.normal(size=cout).astype(np.float32) if shift else None
    acc = np.asarray(jconv(jnp.asarray(xq), jnp.asarray(wq), preferred_element_type=jnp.int32))
    want = np.asarray(jq.conv_i8(jconv, jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(os_),
                                 None if sh is None else jnp.asarray(sh)))
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq)
    for w in (tw, pack_weights_i8(tw)):                 # HWIO and packed
        got_acc = conv_i8_acc_plain(tx, w, padding)
        assert got_acc.dtype == torch.int32
        assert np.array_equal(got_acc.numpy(), acc)
        got = quant.conv_i8(tx, w, torch.from_numpy(os_),
                            None if sh is None else torch.from_numpy(sh), padding=padding)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert torch.equal(conv_i8_acc(tx, tw, padding), got_acc)


def test_conv_i8_cpu_wrapper_runs_the_plain_version():
    rng = np.random.default_rng(4)
    tx = torch.from_numpy(_int8(rng, (1, 5, 6, 16)))
    tw = pack_weights_i8(torch.from_numpy(_int8(rng, (3, 3, 16, 8))))
    sc = torch.rand(8)
    before = (quant.conv_i8.launches, quant.quantize_act.launches)
    assert torch.equal(quant.conv_i8(tx, tw, sc), conv_i8_plain(tx, tw, sc))
    quant.quantize_act(torch.randn(3, 4), 0.1)
    assert (quant.conv_i8.launches, quant.quantize_act.launches) == before


def test_conv_i8_refuses_bad_arguments():
    with pytest.raises(ValueError):
        pack_weights_i8(torch.zeros(3, 3, 4, 4))                 # not int8
    with pytest.raises(ValueError):
        conv_i8_acc_plain(torch.zeros(1, 4, 4, 4, dtype=torch.int8),
                          torch.zeros(3, 3, 4, 4, dtype=torch.int8), (1, 1, -1, 1))


# ---------------------------------------------------------------- calibration

def _jax_ranges(case, quantile=None, x=None):
    return jff.calibrate_int8_ranges(case["variables"], [case["x"] if x is None else x],
                                     dtype=jnp.float32, quantile=quantile)


@pytest.mark.parametrize("quantile", [None, 0.999], ids=["max", "q0.999"])
def test_calibration_matches_jax(case, quantile):
    want = _jax_ranges(case, quantile)
    got = ff.calibrate_int8_ranges(case["model"], [torch.from_numpy(case["x"])],
                                   quantile=quantile)
    assert set(got) == set(want)
    assert {"up2.c1b", "up3.c1b", "up4.c1b"} <= set(got)
    assert set(ff.INT8_DEFAULT_SITES) == set(jff.INT8_DEFAULT_SITES) and \
        ff.INT8_DEFAULT_SITES == jff.INT8_DEFAULT_SITES
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=CALIB_RTOL), k
        assert got[k] > 0


def test_quantile_matches_jnp_quantile():
    """The kthvalue quantile against jnp.quantile, at positions between two
    order statistics, on one and at the ends."""
    rng = np.random.default_rng(5)
    a = np.abs(rng.normal(size=12345)).astype(np.float32)
    for q in (0.0, 0.5, 0.9, 0.999, 0.99999, 1.0):
        want = float(jnp.quantile(jnp.asarray(a), q))
        assert float(ff._quantile(torch.from_numpy(a), q)) == pytest.approx(want, rel=1e-6)


def test_quantile_matches_jnp_quantile_past_2_24():
    """Past 2^24 elements, as a full-width site has them: torch.quantile
    refuses the input, and the position q (n - 1), rounded in float32 as
    jnp.quantile forms it, picks the same order statistics as JAX's."""
    n = (1 << 24) + 12345  # not a float32 integer: float32(n) rounds
    assert int(np.float32(n)) != n
    a = np.abs(np.random.default_rng(6).normal(size=n)).astype(np.float32)
    qs = (0.3, 0.999)
    want = np.asarray(jnp.quantile(jnp.asarray(a), jnp.asarray(qs, jnp.float32)))
    for q, w in zip(qs, want):
        assert float(ff._quantile(torch.from_numpy(a), q)) == pytest.approx(float(w), rel=1e-6)


def test_calibration_aggregates_batches_by_max(case):
    x = case["x"]
    both = ff.calibrate_int8_ranges(case["model"], [torch.from_numpy(x[:1]),
                                                    torch.from_numpy(x[1:])])
    one = [ff.calibrate_int8_ranges(case["model"], [torch.from_numpy(x[i:i + 1])])
           for i in range(2)]
    assert both == {k: max(one[0][k], one[1][k]) for k in both}


# ---------------------------------------------------------------- the int8 forward

def _norm(e):
    e = np.asarray(e, np.float64)
    return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)


INT8_FORMS = {
    "default forms": {},
    # every block form with int8, each stage's both convs
    "mixed forms": {"inconv": "2x2", "down1": "2x2", "down2": "dense", "up3": "dense",
                    "up4": "2x2"},
}
ALL_SITES = tuple(f"{s}.{c}" for s in ff.BLOCKS for c in ("c1", "c2"))


@pytest.mark.parametrize("input_format", ["nhwc", "s2d"])
@pytest.mark.parametrize("forms", list(INT8_FORMS))
@pytest.mark.parametrize("sites", ["default", "all"])
def test_int8_forward_matches_jax(case, forms, sites, input_format):
    """Both packages fed JAX's ranges: the same codes, the same int32
    accumulators; the float32 parts differ by summation order only."""
    ranges = _jax_ranges(case)
    int8_sites = ff.INT8_DEFAULT_SITES if sites == "default" else ALL_SITES
    x = case["x"]
    if input_format == "s2d":
        x = ff.pack_image_s2d(x)
    kw = dict(int8_sites=int8_sites, act_ranges=ranges, stage_forms=INT8_FORMS[forms] or None,
              input_format=input_format)
    je, jm = jff.build_fast_resunet_forward(case["variables"], dtype=jnp.float32, **kw)(x)
    te, tm = ff.build_fast_resunet_forward(case["model"], **kw)(torch.from_numpy(x))
    cos = (_norm(je) * _norm(te.numpy())).sum(-1)
    assert cos.min() >= 0.9999
    assert np.abs(te.numpy() - np.asarray(je)).max() <= 2e-3
    assert np.abs(tm.numpy() - np.asarray(jm)).max() <= 2e-3


def test_int8_bf16_quantizes_from_float32(case):
    """In bfloat16 an activation is quantized from its float32 value, as in
    the JAX package. bfloat16 rounds at other places in the two frameworks,
    so the bfloat16 int8 forwards are held to each other by their mean
    cosine (measured 0.99993; the worst pixel 0.9929) and, against the
    float32 forward, the port no farther off on the mean than JAX is
    (both 0.99966)."""
    y = torch.randn(4, 9, 7, 8).to(torch.bfloat16)
    assert torch.equal(quant.quantize_act(y, 0.01), quant.quantize_act(y.float(), 0.01))
    ranges = _jax_ranges(case)
    x = torch.from_numpy(case["x"])
    kw = dict(int8_sites=ff.INT8_DEFAULT_SITES, act_ranges=ranges)
    e32 = _norm(ff.build_fast_resunet_forward(case["model"])(x)[0].numpy())
    e16, _ = ff.build_fast_resunet_forward(case["model"], dtype=torch.bfloat16, **kw)(x)
    assert e16.dtype == torch.bfloat16
    je, _ = jff.build_fast_resunet_forward(case["variables"], dtype=jnp.bfloat16, **kw)(
        case["x"])
    t16, j16 = _norm(e16.float().numpy()), _norm(np.asarray(je.astype(jnp.float32)))
    assert (t16 * j16).sum(-1).mean() >= 0.9999
    assert (t16 * j16).sum(-1).min() > 0.99
    assert (t16 * e32).sum(-1).mean() >= (j16 * e32).sum(-1).mean() - 1e-4


def test_int8_on_the_fixture_weights_within_jax_bars():
    """JAX's own test on the committed reference weights: the port's int8
    forward (its own calibration) against its float32 forward."""
    from pixel_embedded_affinity_torch.ops.emb2aff import embedding_to_affinity_2d

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "resunet2d_deep.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    filters = tuple(sd[f"{m}.conv.0.weight"].shape[0] for m in (
        "inconv.conv", "down1.block", "down2.block", "down3.block", "down4.block"))
    model = ResidualUNet2DDeep(3, 2, filters, sd["outconv_emb.conv.weight"].shape[0])
    model.load_state_dict(sd)
    model.eval()
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(data["input"], (0, 2, 3, 1))))
    ranges = ff.calibrate_int8_ranges(model, [x])
    e32, _ = ff.build_fast_resunet_forward(model)(x)
    eq, _ = ff.build_fast_resunet_forward(model, int8_sites=ff.INT8_DEFAULT_SITES,
                                          act_ranges=ranges)(x)
    assert (_norm(e32.numpy()) * _norm(eq.numpy())).sum(-1).min() > 0.99
    offsets = [tuple(o) for o in data["offsets"]]
    a32 = embedding_to_affinity_2d(e32, offsets, padding="circular").numpy()
    aq = embedding_to_affinity_2d(eq, offsets, padding="circular").numpy()
    assert np.abs(a32 - aq).max() < 0.05
    assert np.abs(a32 - aq).mean() < 0.005


# ---------------------------------------------------------------- error paths

def test_pallas_form_with_int8_raises(case):
    ranges = _jax_ranges(case)
    with pytest.raises(ValueError, match="pallas"):
        ff.build_fast_resunet_forward(case["model"], int8_sites=("up4.c2",), act_ranges=ranges,
                                      stage_forms={"up4": "pallas"})


def test_missing_range_raises(case):
    with pytest.raises(ValueError, match="lack calibrated ranges"):
        ff.build_fast_resunet_forward(case["model"], int8_sites=("up4.c1",), act_ranges={})


def test_split_site_without_c1b_raises(case):
    ranges = {k: v for k, v in _jax_ranges(case).items() if k != "up3.c1b"}
    with pytest.raises(ValueError, match="calibrate up3.c1b"):
        ff.build_fast_resunet_forward(case["model"], int8_sites=("up3.c1",), act_ranges=ranges)


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("pct", [None, 0.999], ids=["max", "q0.999"])
def test_int8_serving_matches_jax_one_dispatch(tmp_path, pct):
    """run_inference_2d(use_fast=True) with model.int8_infer against JAX's
    run_inference_2d(use_pallas=True, one_dispatch=True), which calibrates
    on the first int8_calib_k images in one batch as the port does: every
    metric within 5e-3 (test_torch_inference2d.py's METRIC_ATOL)."""
    from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
    from pixel_embedded_affinity_tpu.data.cvppp import CVPPPValidation, synthesize
    from pixel_embedded_affinity_tpu.infer.inference2d import (
        run_inference_2d as jax_run_inference_2d)
    from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.infer import run_inference_2d

    folder = str(tmp_path / "CVPPP")
    synthesize(folder, n_train=1, n_valid=3, n_test=0, h=130, w=116)
    over = {"data": {"data_folder": folder},
            "model": {"int8_infer": True, "int8_calib_k": 2, "int8_calib_pct": pct}}
    jcfg = jax_load_config("cvppp", overrides=over)
    jcfg.model.filters = FILTERS
    jcfg.model.s2d_train = False
    jcfg.model.dtype = "float32"
    valid = CVPPPValidation(folder, shifts=tuple(jcfg.data.shifts), neighbor=jcfg.data.neighbor)
    samples = [valid[i] for i in range(len(valid))]
    h, w = samples[0]["image"].shape[:2]
    assert h % 16 == 0 and w % 16 == 0
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, h, w, 3), np.float32), train=False))
    variables = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    _, jagg = jax_run_inference_2d(jcfg, variables, samples, use_pallas=True, one_dispatch=True)
    cfg = load_config("cvppp", overrides={**over, "model": {**over["model"],
                                                             "filters": FILTERS}})
    _, agg = run_inference_2d(cfg, resunet2d_deep_from_flax(variables), samples, device="cpu",
                              use_fast=True, batch_size=2)
    assert set(agg) == set(jagg)
    for k, v in jagg.items():
        np.testing.assert_allclose(agg[k], v, atol=5e-3, err_msg=k)


def test_int8_serving_is_int8(monkeypatch, tmp_path):
    """The serving path quantizes: with model.int8_infer the fast forward is
    built with INT8_DEFAULT_SITES and the calibrated ranges, from
    min(int8_calib_k, N) images."""
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.infer import inference2d

    seen = {}
    real_build, real_cal = inference2d.build_fast_resunet_forward, inference2d.calibrate_int8_ranges

    def build(model, **kw):
        seen["build"] = kw
        return real_build(model, **kw)

    def cal(model, images, **kw):
        seen["calib_shape"] = tuple(images[0].shape)
        seen["calib"] = kw
        return real_cal(model, images, **kw)

    monkeypatch.setattr(inference2d, "build_fast_resunet_forward", build)
    monkeypatch.setattr(inference2d, "calibrate_int8_ranges", cal)
    cfg = load_config("cvppp", overrides={"model": {"filters": FILTERS, "int8_infer": True,
                                                    "int8_calib_k": 8,
                                                    "int8_calib_pct": 0.99}})
    rng = np.random.default_rng(7)
    samples = [{"image": rng.normal(size=(32, 48, 3)).astype(np.float32),
                "seg": (rng.random((32, 48)) > 0.5).astype(np.int32)} for _ in range(3)]
    sd = ResidualUNet2DDeep(3, 2, FILTERS, EMD).state_dict()
    run_inference_2d = inference2d.run_inference_2d
    run_inference_2d(cfg, sd, samples, device="cpu", use_fast=True)
    assert seen["calib_shape"] == (3, 16, 24, 12)
    assert seen["calib"]["quantile"] == 0.99
    assert seen["build"]["int8_sites"] == ff.INT8_DEFAULT_SITES
    assert set(seen["build"]["act_ranges"]) >= set(ff.INT8_DEFAULT_SITES)
    seen.clear()
    run_inference_2d(cfg, sd, samples, device="cpu", use_fast=False)
    assert not seen
