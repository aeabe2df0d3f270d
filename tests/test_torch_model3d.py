"""The port's 3D serving pieces vs the JAX package's, on the CPU: the shift
table, the 3D affinity (oracle, and the kernel's wrapper on a CPU tensor),
``UNetPNIEmbeddingDeep`` and its weight carry-across, the reference golden,
and the tiled engine's grid, weights and stitching. Each side gets the same
seeded numpy inputs.
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
from pixel_embedded_affinity_tpu.models.unet3d_pni import (
    UNetPNIEmbeddingDeep as FlaxPNI)
from pixel_embedded_affinity_tpu.ops import embedding_to_affinity_3d as jax_e2a3d
from pixel_embedded_affinity_tpu.ops.emb2aff_pallas import (
    fused_affinity_3d as jax_fused_affinity_3d)
from pixel_embedded_affinity_tpu.ops.offsets import (
    SHIFTS_3D as JAX_SHIFTS_3D, offsets_3d as jax_offsets_3d)
from pixel_embedded_affinity_tpu.parallel import tiling as jax_tiling
from pixel_embedded_affinity_tpu.postproc.watershed import (
    _regional_maxima as jax_regional_maxima)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import unet_pni_deep_from_flax
from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep
from pixel_embedded_affinity_torch.models.common import upsample_xy_align_corners
from pixel_embedded_affinity_torch.ops import (
    SHIFTS_3D, affinity_3d_plain, embedding_to_affinity_3d, fused_affinity_3d,
    offsets_3d)
from pixel_embedded_affinity_torch.parallel import (
    TiledInference3D, gaussian_blend_weight, regular_grid_dims, tile_grid)
from pixel_embedded_affinity_torch.postproc.watershed import _regional_maxima

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "unet_pni_deep.npz")
FILTERS = (4, 6, 8, 12, 16)
# f32 3D convs summed in another order through ~25 layers; the outputs of
# these widths reach ~0.5 and differ by < 3e-7 (measured); 1e-4 is the
# serving path's affinity bound
MODEL_ATOL = 1e-4
# the reference golden's outputs reach 255; the port is within 3.2e-4 of
# them (1.2e-6 relative), tighter than the JAX test's 1.5e-3 / 1e-2
FIXTURE_TOL = dict(atol=1e-3, rtol=1e-4)


def _emb(shape, seed):
    e = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    e[0, 1, 3, 5, :] = 0.0  # an all-zero vector normalizes to zero
    return e


def test_shift_table_matches_jax():
    assert SHIFTS_3D == JAX_SHIFTS_3D
    assert offsets_3d() == jax_offsets_3d()
    assert offsets_3d((2, 5, 7)) == jax_offsets_3d((2, 5, 7))


# the JAX oracle slices n[s:] against n[:size - s] and needs every axis at
# least as long as its largest shift; the Pallas kernel takes any shape
@pytest.mark.parametrize("shape,with_oracle", [
    ((2, 5, 37, 41, 8), True),    # H not a multiple of 32, W < 128
    ((2, 6, 64, 70, 16), True),
    ((2, 3, 20, 25, 16), False),  # D < 4 and H, W < 27: whole channels zero
    ((1, 2, 9, 30, 8), False),
])
def test_affinity_3d_matches_jax(shape, with_oracle):
    e = _emb(shape, 1)
    ours = embedding_to_affinity_3d(torch.from_numpy(e)).numpy()
    before = fused_affinity_3d.launches
    wrapped = fused_affinity_3d(torch.from_numpy(e)).numpy()
    assert fused_affinity_3d.launches == before  # the CPU runs the plain version
    pallas = np.asarray(jax_fused_affinity_3d(jnp.asarray(e), SHIFTS_3D, 32, True))
    assert ours.shape == (shape[0], 12) + shape[1:4]
    np.testing.assert_allclose(ours, pallas, atol=1e-6)
    np.testing.assert_allclose(wrapped, pallas, atol=1e-6)
    if with_oracle:
        np.testing.assert_allclose(ours, np.asarray(jax_e2a3d(jnp.asarray(e))), atol=1e-6)
    assert np.all(ours[0, :, 1, 3, 5] == 0.0)
    d, h, w = shape[1:4]
    for k, s in enumerate(SHIFTS_3D):  # the out-of-bounds slab is zero
        size = (d, h, w)[k % 3]
        sl = [slice(None)] * 3
        sl[k % 3] = slice(0, min(s, size))
        assert np.all(ours[:, k][(slice(None),) + tuple(sl)] == 0.0)


def test_fused_affinity_3d_takes_strided_view_and_bf16():
    e = _emb((2, 5, 12, 14, 16), 2)
    ncdhw = torch.from_numpy(e).permute(0, 4, 1, 2, 3).contiguous()
    got = fused_affinity_3d(ncdhw.permute(0, 2, 3, 4, 1))
    exp = fused_affinity_3d(torch.from_numpy(e))
    # the CPU reduction order follows the memory layout: f32 rounding only
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=1e-6)
    eb = torch.from_numpy(e).to(torch.bfloat16)
    got_b = affinity_3d_plain(eb)
    assert got_b.dtype == torch.bfloat16
    # bf16 output rounding: half an ulp at |a| <= 1 is 2^-9
    np.testing.assert_allclose(got_b.float().numpy(),
                               embedding_to_affinity_3d(eb.float()).numpy(), atol=2 ** -8)
    with pytest.raises(ValueError):
        fused_affinity_3d(torch.zeros(4, 5, 6, 16))


def test_upsample_xy_is_exact_along_z():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 3, 5, 6, 7)).astype(np.float32))
    got = upsample_xy_align_corners(x)
    assert got.shape == (2, 3, 5, 12, 14)
    for z in range(5):  # each slice is the 2D bilinear upsampling of its own
        exp = torch.nn.functional.interpolate(x[:, :, z], scale_factor=2,
                                              mode="bilinear", align_corners=True)
        # trilinear and bilinear order their f32 products differently
        np.testing.assert_allclose(got[:, :, z].numpy(), exp.numpy(), atol=1e-6)
    # z is copied, not blended: changing slice 2 leaves every other slice
    # bit for bit as it was
    x2 = x.clone()
    x2[:, :, 2] += 1.0
    got2 = upsample_xy_align_corners(x2)
    keep = [0, 1, 3, 4]
    np.testing.assert_array_equal(got2[:, :, keep].numpy(), got[:, :, keep].numpy())


@pytest.fixture(scope="module")
def flax_case():
    """Flax variables with every leaf drawn from a seeded numpy generator
    (BN variances positive), an input, and the Flax outputs (NDHWC)."""
    model = FlaxPNI(filters=FILTERS, emd=16)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 18, 64, 64, 1)), train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.3 if "kernel" in name else 0.1
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    x = rng.normal(size=(2, 1, 18, 64, 64)).astype(np.float32)
    outs = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, np.transpose(x, (0, 2, 3, 4, 1)))
    return variables, x, [np.asarray(o) for o in outs]


def test_unet_pni_matches_flax(flax_case):
    variables, x, jouts = flax_case
    model = UNetPNIEmbeddingDeep(1, FILTERS, 16)
    model.load_state_dict(unet_pni_deep_from_flax(variables))
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
    assert len(outs) == 5
    for o, j in zip(outs, jouts):
        j = np.transpose(j, (0, 4, 1, 2, 3))
        assert o.shape == j.shape
        np.testing.assert_allclose(o.numpy(), j, atol=MODEL_ATOL)
    assert outs[4].shape == (2, 16, 18, 64, 64) and outs[0].shape == (2, 16, 18, 4, 4)


def test_unet_pni_loads_reference_fixture():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = UNetPNIEmbeddingDeep(1, (8, 12, 16, 24, 32), 8)
    model.load_state_dict(sd)  # strict: every reference name is the port's
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(data["input"]))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), data[f"out/{i}"], **FIXTURE_TOL)


def test_ac3ac4_preset_matches_jax():
    cfg, jcfg = load_config("ac3ac4"), jax_load_config("ac3ac4")
    for f in ("arch", "input_nc", "output_nc", "emd", "filters"):
        assert getattr(cfg.model, f) == getattr(jcfg.model, f), f
    for f in ("dataset_name", "crop_size", "train_split", "padding_3d"):
        assert getattr(cfg.data, f) == getattr(jcfg.data, f), f
    # the JAX package's TPU serving choices are off by default in the port
    # and served when set (fast_tiled_infer: the dense module is the faster
    # graph on the H100)
    assert not cfg.model.bf16_tiled_infer and not cfg.model.fast_tiled_infer


def test_train_refuses_3d(tmp_path):
    """3D training is ported: the ac3ac4 preset's train fields are the JAX
    preset's, and with device_resident off ``train`` builds the AC3/AC4
    host disk sampler (ported too), which reads data.data_folder's HDF5
    volumes: a folder without them raises."""
    from pixel_embedded_affinity_torch.train import train

    cfg, jcfg = load_config("ac3ac4"), jax_load_config("ac3ac4")
    for k in vars(cfg.train):
        assert getattr(cfg.train, k) == getattr(jcfg.train, k), f"train.{k}"
    assert cfg.train.embedding_mode == 5 and cfg.train.valid_decoders == ("waterz",)
    for k in ("device_gt", "device_ema"):
        assert getattr(cfg.data, k) and getattr(jcfg.data, k), k
    # the device-resident sampler is ported: on in both presets
    assert jcfg.data.device_resident and cfg.data.device_resident
    cfg.data.device_resident = False
    cfg.data.data_folder = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="AC4_inputs.h5"):
        train(cfg, max_iters=1, device="cpu")


@pytest.mark.parametrize("padded,crop,stride,dims", [
    ((108, 1120, 1120), (18, 160, 160), (10, 80, 80), (10, 13, 13)),  # AC3
    ((28, 1120, 1120), (18, 160, 160), (10, 80, 80), (2, 13, 13)),    # AC4 valid
    ((28, 112, 112), (18, 64, 64), (10, 32, 32), None),               # clamped
    ((32, 196, 196), (18, 160, 160), (10, 80, 80), None),
])
def test_tile_grid_matches_jax(padded, crop, stride, dims):
    assert regular_grid_dims(padded, crop, stride) == dims
    assert regular_grid_dims(padded, crop, stride) == jax_tiling.regular_grid_dims(
        padded, crop, stride)
    grid = tile_grid(padded, crop, stride)
    assert grid == jax_tiling.tile_grid(padded, crop, stride)
    if dims is not None:
        assert len(grid) == int(np.prod(dims))


@pytest.mark.parametrize("size,sigma", [((18, 160, 160), 0.2), ((12, 32, 40), 0.3)])
def test_gaussian_blend_weight_matches_jax(size, sigma):
    np.testing.assert_array_equal(gaussian_blend_weight(size, sigma),
                                  jax_tiling.gaussian_blend_weight(size, sigma))


def test_tiled_engine_matches_jax():
    """A predictor that mixes each tile's voxels differently per channel,
    through both engines: 3*3*3 = 27 tiles at batch 4 (a short last batch)."""
    rng = np.random.default_rng(5)
    vol = rng.random((20, 52, 52)).astype(np.float32)
    mix = rng.normal(size=(3, 3)).astype(np.float32)

    def predict_np(tiles):  # (B, d, h, w, 1) -> (B, 3, d, h, w)
        t = tiles[..., 0]
        return np.stack([mix[k, 0] * t + mix[k, 1] * t ** 2 + mix[k, 2] * np.sin(3 * t)
                         for k in range(3)], axis=1)

    batches = []

    def predict_torch(tiles):  # (B, 1, d, h, w) -> (B, 3, d, h, w)
        batches.append(tiles.shape[0])
        return torch.from_numpy(predict_np(tiles.permute(0, 2, 3, 4, 1).numpy()))

    kw = dict(crop_size=(12, 32, 32), stride=(6, 16, 16), padding=(2, 6, 6), batch_size=4)
    exp = jax_tiling.TiledInference3D(**kw, device_accumulate=True).run(vol, predict_np, 3)
    got = TiledInference3D(**kw).run(vol, predict_torch, 3, device="cpu")
    assert got.shape == exp.shape == (3, 20, 52, 52) and got.dtype == np.float32
    assert batches == [4] * 6 + [3]  # a short last batch: no tile predicted twice
    np.testing.assert_allclose(got, exp, atol=1e-6)


def test_regional_maxima_matches_jax():
    """The port keeps the candidates the JAX package's plateau loop keeps,
    on images with many plateaus and on smooth ones."""
    from scipy import ndimage

    rng = np.random.default_rng(6)
    for i in range(6):
        x = (rng.integers(0, 4, (40, 50)).astype(np.float64) if i % 2 == 0
             else ndimage.gaussian_filter(rng.random((60, 70)), 2))
        np.testing.assert_array_equal(_regional_maxima(x), jax_regional_maxima(x))
