"""The port's folded-BatchNorm 3D serving graph (``models/fast_forward3d.py``,
``model.fast_tiled_infer``) against the JAX package's on the CPU: the graph
against JAX's ``build_fast_pni_forward`` on the same weights (Flax
variables drawn from a seeded numpy generator, BatchNorm statistics far from
identity, carried across by ``unet_pni_deep_from_flax``) in float32 and
bfloat16; ``run_inference_3d`` with the graph on and off against JAX's on
the same volume; the fast canvas against the dense one; and the 3D
validation's float32 affinities in bfloat16.
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

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data.ac3ac4 import synthesize_volume as jax_synthesize_volume
from pixel_embedded_affinity_tpu.infer.inference3d import (
    run_inference_3d as jax_run_inference_3d)
from pixel_embedded_affinity_tpu.models.fast_forward3d import (
    build_fast_pni_forward as jax_build_fast_pni_forward)
from pixel_embedded_affinity_tpu.models.unet3d_pni import UNetPNIEmbeddingDeep as FlaxPNI

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.infer import build_model, run_inference_3d
from pixel_embedded_affinity_torch.infer.inference3d import build_tiled_predictor, serves_fast
from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep, build_fast_pni_forward
from pixel_embedded_affinity_torch.ops import SHIFTS_3D, affinity_3d_plain
from pixel_embedded_affinity_torch.parallel import TiledInference3D

FILTERS = (4, 6, 8, 12, 16)
# JAX's own bars (tests/test_fast_forward3d.py): float32 to 2e-5; bfloat16
# at a cosine of the embedding vectors against float32's, min and mean
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_COS_MIN, BF16_COS_MEAN = 0.95, 0.995
# the fast canvas against the dense one (tests/test_inference_e2e.py:164),
# and either package's canvas against the other's, as test_torch_inference3d
CANVAS_ATOL = 1e-4
GEOMETRY = dict(crop_size=(18, 64, 64), stride=(10, 32, 32), padding=(2, 8, 8),
                batch_size=4)


def _draw_variables(seed: int):
    """Flax variables of the PNI model at FILTERS, every leaf drawn from a
    seeded numpy generator: kernels at 1/sqrt(fan-in), BatchNorm variances
    in [0.5, 1.5], means, scales and biases spread by 0.1, so folding is
    exercised far from identity while activations stay of order 1."""
    model = FlaxPNI(filters=FILTERS, emd=16)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 18, 32, 32, 1)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        scale = 1 / np.sqrt(np.prod(leaf.shape[:-1])) if "kernel" in name else 0.1
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-8)


@pytest.fixture(scope="module")
def case():
    variables = _draw_variables(0)
    x = np.random.default_rng(1).normal(size=(2, 6, 32, 48, 1)).astype(np.float32)
    model = UNetPNIEmbeddingDeep(1, FILTERS, 16)
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    ref = jax.jit(lambda v, a: FlaxPNI(filters=FILTERS, emd=16).apply(
        v, a, train=False)[-1])(variables, x)
    return dict(variables=variables, x=x, model=model.eval(), ref=np.asarray(ref))


def test_fast_pni_forward_matches_jax_f32(case):
    jfast = jax_build_fast_pni_forward(case["variables"], dtype=jnp.float32,
                                       filters=FILTERS, emd=16)
    exp = np.asarray(jax.jit(jfast)(case["x"]))
    got = build_fast_pni_forward(case["model"])(torch.from_numpy(case["x"]))
    assert got.shape == exp.shape == (2, 6, 32, 48, 16) and got.dtype == torch.float32
    # the embedding reaches K5f as a view of the (B*D, emd, H, W) output
    assert got.stride() == (6 * 16 * 32 * 48, 16 * 32 * 48, 48, 1, 32 * 48)
    np.testing.assert_allclose(got.numpy(), exp, **F32_TOL)
    # and the graph is the module's: the dense module's embedding, permuted
    np.testing.assert_allclose(got.numpy(), case["ref"], **F32_TOL)


def test_fast_pni_forward_holds_float64_of_the_module(case):
    """Folding re-associates float32 sums: the fast graph is held to the
    dense module run in float64 (measured: 2.3e-6 of outputs up to 3.6,
    one thread; the module's own float32 run is 3.2e-6 off), and run in
    float64 itself it is the module's graph to float64 rounding."""
    import copy

    x = torch.from_numpy(case["x"])
    m64 = copy.deepcopy(case["model"]).double()
    with torch.no_grad():
        ref = m64(x.permute(0, 4, 1, 2, 3).double())[4].permute(0, 2, 3, 4, 1)
        dense = case["model"](x.permute(0, 4, 1, 2, 3))[4].permute(0, 2, 3, 4, 1)
    got = build_fast_pni_forward(case["model"])(x)
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item()
    assert err <= 2 * (dense.double() - ref).abs().max().item()
    got64 = build_fast_pni_forward(m64, dtype=torch.float64, emb_f32=False)(x.double())
    assert got64.dtype == torch.float64
    assert (got64 - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("emb_f32", [True, False])
def test_fast_pni_forward_bf16_at_jax_bar(case, emb_f32):
    """bfloat16 compute at the JAX package's cosine bar, against the
    float32 module and JAX's own bfloat16 fast graph."""
    got = build_fast_pni_forward(case["model"], dtype="bfloat16", emb_f32=emb_f32)(
        torch.from_numpy(case["x"]))
    assert got.dtype == (torch.float32 if emb_f32 else torch.bfloat16)
    got = got.float().numpy()
    jfast = jax_build_fast_pni_forward(case["variables"], dtype=jnp.bfloat16,
                                       filters=FILTERS, emd=16)
    jb = np.asarray(jax.jit(jfast)(case["x"]))
    for ref in (case["ref"], jb):
        cos = _cos(got, ref)
        assert cos.min() > BF16_COS_MIN and cos.mean() > BF16_COS_MEAN, (cos.min(), cos.mean())
    jcos = _cos(jb, case["ref"])
    assert jcos.min() > BF16_COS_MIN and jcos.mean() > BF16_COS_MEAN


def test_predictor_rule_matches_jax():
    """The fast graph serves with fast_tiled_infer and the PNI arch only, as
    in JAX. The flag is off by default in the port (the dense module is the
    faster graph on the H100) and on in JAX."""
    cfg = load_config("ac3ac4")
    assert not cfg.model.fast_tiled_infer and jax_load_config("ac3ac4").model.fast_tiled_infer
    assert not serves_fast(cfg)
    assert serves_fast(load_config("ac3ac4", {"model": {"fast_tiled_infer": True}}))
    assert not serves_fast(load_config("ac3ac4", {"model": {"arch": "unet3d_mala",
                                                            "fast_tiled_infer": True}}))


@pytest.fixture(scope="module")
def volume_case():
    raw, label = jax_synthesize_volume(d=22, h=80, w=80, n_cells=14, seed=7)
    variables = _draw_variables(2)
    return dict(vol=raw.astype(np.float32) / 255.0, label=label, variables=variables,
                sd=unet_pni_deep_from_flax(variables))


def _jax_cfg(fast: bool):
    cfg = jax_load_config("ac3ac4")
    cfg.model.filters = FILTERS
    cfg.model.dtype = "float32"
    cfg.model.bf16_tiled_infer = False
    cfg.model.fast_tiled_infer = fast
    return cfg


@pytest.mark.parametrize("fast", [True, False])
def test_run_inference_3d_matches_jax(volume_case, fast):
    """The tiled canvas and the mutex segmentation, the graph on and off
    (the port's default), each against JAX's on the same volume and
    weights."""
    cfg = load_config("ac3ac4", {"model": {"filters": FILTERS, "fast_tiled_infer": fast}})
    got, res = run_inference_3d(cfg, volume_case["sd"], volume_case["vol"],
                                gt=volume_case["label"], decoders=("mutex",), device="cpu",
                                **GEOMETRY)
    exp, jres = jax_run_inference_3d(_jax_cfg(fast), volume_case["variables"],
                                     volume_case["vol"], gt=volume_case["label"],
                                     decoders=("mutex",), use_pallas=False, **GEOMETRY)
    assert got.shape == exp.shape == (12,) + volume_case["vol"].shape
    np.testing.assert_allclose(got, np.asarray(exp), atol=CANVAS_ATOL)
    assert np.array_equal(res["mutex"][0], jres["mutex"][0])
    for k, v in jres["mutex"][1].items():
        np.testing.assert_allclose(res["mutex"][1][k], v, atol=5e-3, err_msg=k)


def test_fast_canvas_matches_dense(volume_case):
    kw = dict(decoders=(), device="cpu", **GEOMETRY)
    fast, _ = run_inference_3d(load_config("ac3ac4", {"model": {
        "filters": FILTERS, "fast_tiled_infer": True}}), volume_case["sd"],
        volume_case["vol"], **kw)
    dense, _ = run_inference_3d(load_config("ac3ac4", {"model": {"filters": FILTERS}}),
                                volume_case["sd"], volume_case["vol"], **kw)
    np.testing.assert_allclose(fast, dense, atol=CANVAS_ATOL)
    assert np.abs(fast - dense).max() > 0  # two graphs, not one


def test_bf16_validation_hands_k5f_float32(volume_case, monkeypatch):
    """3D validation in bfloat16 serves as run_inference_3d serves: the
    bfloat16 embedding is cast to float32 before the affinity, so its
    canvas is that of a float32-affinity predictor on the same bfloat16
    embedding to 1e-6; the affinity taken in bfloat16 (the old behaviour)
    is off it by bfloat16's rounding."""
    import types

    from pixel_embedded_affinity_torch.infer import inference3d
    from pixel_embedded_affinity_torch.train.loop import valid_geometry_3d, validate_3d

    crop = (18, 32, 32)
    cfg = load_config("ac3ac4", {"model": {"filters": FILTERS, "dtype": "bfloat16"},
                                 "data": {"crop_size": crop},
                                 "train": {"valid_decoders": ("waterz",)}})
    vol, label = volume_case["vol"][:20, :48, :48], volume_case["label"][:20, :48, :48]
    seen = {}
    real = inference3d.run_inference_3d

    def spy(*args, **kwargs):
        affs, out = real(*args, **kwargs)
        seen["affs"] = affs
        return affs, out

    monkeypatch.setattr(inference3d, "run_inference_3d", spy)
    model = build_model(cfg, volume_case["sd"], "cpu")
    out = validate_3d(cfg, types.SimpleNamespace(model=model),
                      types.SimpleNamespace(raw=vol, label=label), "cpu")
    assert np.isfinite(out["valid/affs_mse"])

    stride, padding = valid_geometry_3d(crop)
    engine = TiledInference3D(crop_size=crop, stride=stride, padding=padding, batch_size=4)
    assert model.compute_dtype == torch.bfloat16

    def predictor(f32: bool):
        @torch.no_grad()
        def predict(t):
            emb = model(t)[4].permute(0, 2, 3, 4, 1)
            return affinity_3d_plain(emb.float() if f32 else emb, SHIFTS_3D).float().relu_()
        return predict

    ref = engine.run(vol, predictor(True), len(SHIFTS_3D), device="cpu")
    old = engine.run(vol, predictor(False), len(SHIFTS_3D), device="cpu")
    np.testing.assert_allclose(seen["affs"], ref, atol=1e-6)
    assert np.abs(old - ref).max() > 1e-4
    # and the predictor the validation ran is the serving one
    np.testing.assert_allclose(
        engine.run(vol, build_tiled_predictor(model), len(SHIFTS_3D), device="cpu"),
        ref, atol=1e-6)
