"""The port's folded-BatchNorm fast forward
(``pixel_embedded_affinity_torch/models/fast_forward.py``) against the JAX
package's ``models/fast_forward.py`` on the CPU, in float32.

The JAX variables are drawn once per module with numpy in the tree shape
``jax.eval_shape(model.init, ...)`` gives (no ``init`` run), with
non-trivial BatchNorm statistics (running means ~ N(0, 0.1), variances in
[0.5, 1.5], scales ~ 1 + N(0, 0.1)), so the fold is tested; they reach the
port through ``convert.resunet2d_deep_from_flax``. Tolerance: atol 2e-4,
the JAX package's own for this function (tests/test_fast_forward.py), on
embeddings of magnitude ~7 (the two sum convs in other orders: ~4e-6
apart here). The JAX "pallas" block runs K8 in interpret mode.
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

from pixel_embedded_affinity_torch.convert import resunet2d_deep_from_flax
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.models import fast_forward as ff
from pixel_embedded_affinity_torch.models.resunet2d import ResidualBlock
from pixel_embedded_affinity_torch.ops import fused_s2d_block

FILTERS = (4, 6, 8, 12, 16)
EMD = 16
ATOL = 2e-4
PALLAS = {k: "pallas" for k in ("inconv", "down1", "down2", "up3", "up4")}
MIXED = {"inconv": "2x2", "down1": "2x2", "down2": "dense", "up3": "dense", "up4": "2x2"}


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
    jax_default = [np.asarray(o) for o in
                   jff.build_fast_resunet_forward(variables, dtype=jnp.float32)(x)]
    return dict(variables=variables, model=model.eval(), x=x, jax_default=jax_default)


VARIANTS = {
    "default forms": dict(),
    "s2d input": dict(input_format="s2d"),
    "s2d input, head at full resolution": dict(input_format="s2d", head_at_fullres=True),
    "mixed stage forms": dict(stage_forms=MIXED),
    "no mask": dict(with_mask=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fast_forward_matches_jax(case, variant):
    kw = VARIANTS[variant]
    x = case["x"]
    inp = ff.pack_image_s2d(x) if kw.get("input_format") == "s2d" else x
    ref = jff.build_fast_resunet_forward(case["variables"], dtype=jnp.float32, **kw)(inp)
    got = ff.build_fast_resunet_forward(case["model"], **kw)(torch.from_numpy(inp))
    assert got[0].shape == (2, 64, 48, EMD) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    if kw.get("with_mask", True):
        assert got[1].shape == (2, 64, 48, 2)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=ATOL)
    else:
        assert got[1] is None and ref[1] is None


def test_all_pallas_forward_matches_jax(case):
    """Every s2d stage as one K8 call (its plain version on the CPU): the
    same function as JAX's default forms."""
    before = fused_s2d_block.launches
    emb, mask = ff.build_fast_resunet_forward(case["model"], stage_forms=PALLAS)(
        torch.from_numpy(case["x"]))
    assert fused_s2d_block.launches == before
    np.testing.assert_allclose(emb.numpy(), case["jax_default"][0], atol=ATOL)
    np.testing.assert_allclose(mask.numpy(), case["jax_default"][1], atol=ATOL)


def test_fast_forward_matches_the_dense_modules(case):
    """The port's fast forward against the port's own eval-mode module and
    the JAX module: three forms of one function."""
    x = case["x"]
    emb, mask = ff.build_fast_resunet_forward(case["model"])(torch.from_numpy(x))
    with torch.no_grad():
        outs = case["model"](torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(emb.numpy(), outs[4].permute(0, 2, 3, 1).numpy(), atol=ATOL)
    np.testing.assert_allclose(mask.numpy(), outs[5].permute(0, 2, 3, 1).numpy(), atol=ATOL)
    jouts = JaxResUNet(out_channels=2, nfeatures=FILTERS, emd=EMD).apply(
        case["variables"], x, train=False)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jouts[4]), atol=ATOL)


def test_fast_forward_raises_as_jax_does(case):
    model, variables = case["model"], case["variables"]
    for bad, match in (({"bogus": "dense"}, "unknown stage_forms"),
                       ({"down3": "dense"}, "layout mismatch"),
                       ({"inconv": False}, "layout mismatch")):
        with pytest.raises(ValueError, match=match):
            jff.build_fast_resunet_forward(variables, stage_forms=bad)
        with pytest.raises(ValueError, match=match):
            ff.build_fast_resunet_forward(model, stage_forms=bad)
    # int8 serving (tests/test_torch_int8.py): a site without a calibrated
    # range, and int8 on the pallas form, raise in both packages
    for kw, match in ((dict(int8_sites=("up4.c1",)), "lack calibrated ranges"),
                      (dict(int8_sites=("up4.c2",), act_ranges={"up4.c2": 1.0},
                            stage_forms={"up4": "pallas"}), "pallas")):
        with pytest.raises(ValueError, match=match):
            jff.build_fast_resunet_forward(variables, **kw)
        with pytest.raises(ValueError, match=match):
            ff.build_fast_resunet_forward(model, **kw)
    with pytest.raises(ValueError, match="divisible by 16"):
        ff.build_fast_resunet_forward(model)(torch.zeros(1, 40, 48, 3))
    with pytest.raises(ValueError, match="input_format"):
        ff.build_fast_resunet_forward(model, input_format="nchw")
    model.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            ff.build_fast_resunet_forward(model)
    finally:
        model.eval()


def _block_weights(rng, ci, co):
    """JAX (params, batch_stats) of one ResidualBlock with conv biases and
    non-trivial BatchNorm statistics, and the port's block with the same
    weights."""
    p, s, sd = {}, {}, {}
    for conv, bn, cin, key in (("conv1", "bn1", ci, "conv.0"), ("conv2", "bn2", co, "conv.3"),
                               ("project_conv", "project_bn", ci, "project.0")):
        k = (rng.normal(size=(3, 3, cin, co)) / np.sqrt(9 * cin)).astype(np.float32)
        b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
        scale = (1 + 0.1 * rng.normal(size=(co,))).astype(np.float32)
        bias = (0.1 * rng.normal(size=(co,))).astype(np.float32)
        mean = (0.1 * rng.normal(size=(co,))).astype(np.float32)
        var = rng.uniform(0.5, 1.5, (co,)).astype(np.float32)
        p[conv] = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
        p[bn] = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        s[bn] = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
        bkey = key[:-1] + str(int(key[-1]) + 1)
        sd.update({f"{key}.weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                   f"{key}.bias": torch.from_numpy(b),
                   f"{bkey}.weight": torch.from_numpy(scale),
                   f"{bkey}.bias": torch.from_numpy(bias),
                   f"{bkey}.running_mean": torch.from_numpy(mean),
                   f"{bkey}.running_var": torch.from_numpy(var),
                   f"{bkey}.num_batches_tracked": torch.tensor(0)})
    block = ResidualBlock(ci, co)
    block.load_state_dict(sd)
    return p, s, block.eval()


@pytest.mark.parametrize("split", [None, 4])
@pytest.mark.parametrize("form", [False, "dense", "2x2", "pallas"])
def test_block_forms_match_jax(form, split):
    rng = np.random.default_rng(3)
    ci, co = 6, 8
    p, s, block = _block_weights(rng, ci, co)
    reps = 1 if form is False else 4
    x = rng.normal(size=(2, 8, 6, reps * ci)).astype(np.float32)
    if split is None:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        parts = (x[..., :reps * split], x[..., reps * split:])
        if form is not False:  # each part is its own s2d tensor
            xd = x.reshape(2, 8, 6, 2, 2, ci)
            parts = tuple(np.ascontiguousarray(xd[..., a:b].reshape(2, 8, 6, -1))
                          for a, b in ((0, split), (split, ci)))
        jx = tuple(jnp.asarray(a) for a in parts)
        tx = tuple(torch.from_numpy(a) for a in parts)
    jblk = jff._BlockW(p, s, jnp.float32, form, split_at=split)
    jblk.interpret = True
    ref = np.asarray(jblk(jx))
    got = ff._BlockW(block, torch.float32, form, split_at=split)(tx)
    assert got.shape == ref.shape == (2, 8, 6, reps * co)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_block_int8_options_raise():
    """As the JAX class: int8 on the pallas form is a ValueError, an int8
    conv without its calibrated scale a KeyError."""
    _, _, block = _block_weights(np.random.default_rng(4), 3, 16)
    for kw in (dict(int8_c1=True), dict(int8_c2=True)):
        with pytest.raises(ValueError, match="pallas"):
            ff._BlockW(block, torch.float32, "pallas", scales={"c1": 1.0, "c2": 1.0}, **kw)
        with pytest.raises(KeyError):
            ff._BlockW(block, torch.float32, "dense", **kw)


def test_fold_and_upsample_helpers_match_jax():
    rng = np.random.default_rng(5)
    _, _, block = _block_weights(rng, 3, 5)
    bn, conv = block.conv[1], block.conv[0]
    scale, shift = ff._fold_bn(bn, conv.bias)
    jscale, jshift = jff._fold_bn(
        {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
        {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()},
        conv.bias.detach().numpy())
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(jshift), rtol=1e-6, atol=1e-7)
    for n_out, n_in in ((10, 5), (4, 1), (16, 8)):
        np.testing.assert_array_equal(ff._interp_matrix(n_out, n_in),
                                      np.asarray(jff._interp_matrix(n_out, n_in)))
    y = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(ff._upsample2x_to_s2d(torch.from_numpy(y), torch.float32).numpy(),
                               np.asarray(jff._upsample2x_to_s2d(jnp.asarray(y), jnp.float32)),
                               atol=1e-6)
    xs = rng.normal(size=(2, 4, 3, 12)).astype(np.float32)
    np.testing.assert_array_equal(ff._pool_s2d_to_direct(torch.from_numpy(xs)).numpy(),
                                  np.asarray(jff._pool_s2d_to_direct(jnp.asarray(xs))))
