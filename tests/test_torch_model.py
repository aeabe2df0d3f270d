"""Port's ResidualUNet2DDeep vs the Flax model and the reference fixture.

Tolerance atol 2e-4, rtol 1e-3 on all six outputs: f32 convs summed in
another order through ~20 layers, the bound ``tests/test_model_parity.py``
uses for the same model (JAX at 'highest' precision, set in conftest).
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

from pixel_embedded_affinity_tpu.models.resunet2d import (
    ResidualUNet2DDeep as FlaxResUNet)
from pixel_embedded_affinity_tpu.train.convert_torch import convert_resunet2d_deep

from pixel_embedded_affinity_torch.convert import (
    load_torch_state_dict, resunet2d_deep_from_flax)
from pixel_embedded_affinity_torch.device import float32_convs
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.ops import (
    embedding_to_affinity_2d, fused_affinity_2d)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "resunet2d_deep.npz")
WIDTHS = (8, 12, 16, 24, 32)
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def flax_case():
    """Flax variables with every leaf drawn from a seeded numpy generator
    (BN variances positive), an input, and the Flax outputs (NHWC)."""
    model = FlaxResUNet(out_channels=2, nfeatures=WIDTHS, emd=8)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        scale = 0.3 if "kernel" in name else 0.1
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    outs = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    return variables, x, [np.asarray(o) for o in outs]


def _port(sd, widths, emd):
    m = ResidualUNet2DDeep(3, 2, widths, emd)
    m.load_state_dict(sd)
    return m.eval()


def test_port_matches_flax_on_same_weights(flax_case):
    variables, x, jouts = flax_case
    model = _port(resunet2d_deep_from_flax(variables), WIDTHS, 8)
    with torch.no_grad():
        touts = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(touts) == 6
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j, **TOL)


def test_flax_conversion_round_trip(flax_case):
    variables = flax_case[0]
    back = convert_resunet2d_deep(resunet2d_deep_from_flax(variables))
    leaves_a = jax.tree_util.tree_leaves_with_path(variables)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves_a) == len(leaves_b)
    for path, a in leaves_a:
        np.testing.assert_array_equal(np.asarray(leaves_b[path]), np.asarray(a))


def test_port_matches_reference_fixture():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd/")}
    model = _port(sd, WIDTHS, 8)
    with torch.no_grad():
        outs = model(torch.from_numpy(data["input"]))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), data[f"out/{i}"], **TOL)

    emb = outs[4].permute(0, 2, 3, 1)
    offsets = data["offsets"].tolist()
    circ = embedding_to_affinity_2d(emb, offsets, padding="circular")
    np.testing.assert_allclose(circ.numpy(), data["affs"], **TOL)
    # the kernel's wrapper ('valid') agrees with the circular golden
    # everywhere outside the wrap band and is 0 inside it
    valid = fused_affinity_2d(emb, offsets).numpy()
    h, w = valid.shape[-2:]
    for k, (oy, ox) in enumerate(offsets):
        band = np.zeros((h, w), bool)
        band[:max(-oy, 0)] = True
        band[:, :max(-ox, 0)] = True
        np.testing.assert_allclose(valid[0, k][~band], data["affs"][0, k][~band], **TOL)
        assert np.all(valid[0, k][band] == 0)


def test_load_torch_state_dict_strips_module_prefix(tmp_path):
    data = np.load(FIXTURE)
    sd = {"module." + k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd/")}
    path = tmp_path / "ref.ckpt"
    torch.save({"current_iter": 1, "model_weights": sd}, path)
    loaded = load_torch_state_dict(str(path))
    _port(loaded, WIDTHS, 8)  # strict load: every reference name matches
    assert not any(k.startswith("module.") for k in loaded)


@pytest.mark.parametrize("before", [True, False])
def test_float32_convs_turns_tf32_off_and_restores(before):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = before
    try:
        with float32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is before
        with pytest.raises(ValueError):
            with float32_convs():
                raise ValueError
        assert torch.backends.cudnn.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32 = prev
