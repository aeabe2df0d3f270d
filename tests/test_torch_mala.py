"""The port's ``UNet3DMALADeep`` on the CPU: the committed reference golden
(``tests/fixtures/unet3d_mala_small.npz``, reduced widths, reference names)
at the JAX package's tolerance, the module against JAX's on drawn weights
carried across by ``unet3d_mala_from_flax``, and the refusals of training
and tiled serving, which the JAX package cannot do either.
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
from pixel_embedded_affinity_tpu.models.unet3d_mala import UNet3DMALADeep as FlaxMALA
from pixel_embedded_affinity_tpu.train.convert_torch import convert_unet3d_mala_deep
from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import unet3d_mala_from_flax
from pixel_embedded_affinity_torch.infer import build_model, run_inference_3d
from pixel_embedded_affinity_torch.models import UNet3DMALADeep

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "unet3d_mala_small.npz")
# the JAX package's golden tolerance (tests/test_model_parity.py)
FIXTURE_TOL = dict(atol=2e-4, rtol=1e-3)


def _fixture():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    x = np.random.default_rng(int(data["input_seed"][0])).standard_normal(
        tuple(data["input_shape"])).astype(np.float32)
    return data, sd, x


def test_mala_loads_reference_golden():
    data, sd, x = _fixture()
    widths = tuple(int(v) for v in data["widths"])
    model = UNet3DMALADeep(int(data["emd"][0]), widths)
    model.load_state_dict(sd)  # strict: every reference name is the port's
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    ref = data["out/0"]
    assert out.shape == ref.shape == (1, 4, 1, 2, 2)
    np.testing.assert_allclose(out.numpy(), ref, **FIXTURE_TOL)


def test_mala_converters_are_inverses():
    """The JAX package's converter of the reference state dict, then the
    port's back: every tensor bit for bit."""
    _, sd, _ = _fixture()
    back = unet3d_mala_from_flax(convert_unet3d_mala_deep(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("widths,shape", [
    ((2, 3, 4, 5), (1, 29, 214, 214)),   # the golden's geometry, batch 2
    ((3, 4, 6, 8), (1, 31, 232, 241)),   # deeper z, uneven x
])
def test_mala_matches_jax(widths, shape):
    rng = np.random.default_rng(2)
    model = FlaxMALA(emd=5, widths=widths)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:] + (1,)), train=False))

    def draw(leaf):
        fan_in = np.prod(leaf.shape[:-1]) if leaf.ndim > 1 else 1
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    variables = jax.tree_util.tree_map(draw, shapes)
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    exp = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, np.transpose(x, (0, 2, 3, 4, 1))))
    ours = UNet3DMALADeep(5, widths)
    ours.load_state_dict(unet3d_mala_from_flax(variables))
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x)).numpy()
    exp = np.transpose(exp, (0, 4, 1, 2, 3))
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-4)


def test_mala_arch_builds_as_jax():
    cfg = load_config(overrides={"model": {"arch": "unet3d_mala", "input_nc": 1}})
    model = build_model(cfg, device="cpu")
    assert isinstance(model, UNet3DMALADeep) and not model.training
    jmodel = jax_build_model(jax_load_config(overrides={"model": {"arch": "unet3d_mala"}}))
    assert isinstance(jmodel, FlaxMALA) and jmodel.widths == (12, 60, 300, 1500)
    assert model.conv8.weight.shape == (1500, 1500, 3, 3, 3)
    assert model.dconv1.weight.shape == (1500, 1, 1, 3, 3)


def test_mala_training_and_tiled_serving_refused():
    from pixel_embedded_affinity_torch.train import train

    cfg = load_config("ac3ac4", {"model": {"arch": "unet3d_mala"}})
    with pytest.raises(NotImplementedError, match="five outputs.*no BatchNorm"):
        train(cfg, max_iters=1, device="cpu")
    with pytest.raises(NotImplementedError, match=r"\(25, 56, 56\)"):
        run_inference_3d(cfg, None, np.zeros((20, 64, 64), np.float32), decoders=(),
                         device="cpu")
