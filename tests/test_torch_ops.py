"""Port's affinity ops vs the JAX package's, on the CPU.

The plain torch ops must match the jnp oracles at 1e-6 (same f32 math,
other summation order); the K1 wrapper on a CPU tensor runs its plain
version and must match the Pallas kernel in interpret mode at 1e-5, the
tolerance ``tests/test_emb2aff_pallas.py`` holds the kernel to.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.ops import (
    embedding_to_affinity_2d as jax_e2a, multi_offset as jax_multi_offset,
    normalize_embedding as jax_normalize)
from pixel_embedded_affinity_tpu.ops.emb2aff_pallas import (
    fused_affinity_2d as jax_fused_affinity_2d)

from pixel_embedded_affinity_torch.ops import (
    affinity_2d_plain, embedding_to_affinity_2d, fused_affinity_2d,
    multi_offset, normalize_embedding)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emb(shape, seed):
    e = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    e[0, 3, 5, :] = 0.0  # an all-zero vector normalizes to zero
    return e


@pytest.mark.parametrize("neighbor", [4, 8])
def test_multi_offset_matches_jax(neighbor):
    shifts = [1, 3, 5, 9, 27]
    assert multi_offset(shifts, neighbor) == jax_multi_offset(shifts, neighbor)


def test_normalize_embedding_matches_jax():
    e = _emb((2, 9, 7, 16), 0)
    got = normalize_embedding(torch.from_numpy(e)).numpy()
    exp = np.asarray(jax_normalize(jnp.asarray(e)))
    np.testing.assert_allclose(got, exp, atol=1e-6)
    assert np.all(got[0, 3, 5] == 0.0)


@pytest.mark.parametrize("padding", ["valid", "circular"])
@pytest.mark.parametrize("neighbor", [4, 8])
def test_embedding_to_affinity_2d_matches_jax(padding, neighbor):
    e = _emb((2, 37, 53, 16), 1)  # H, W divisible by nothing useful
    offsets = multi_offset([1, 3, 5, 9, 27], neighbor)
    got = embedding_to_affinity_2d(torch.from_numpy(e), offsets,
                                   padding=padding).numpy()
    exp = np.asarray(jax_e2a(jnp.asarray(e), offsets, padding=padding))
    assert got.shape == (2, len(offsets), 37, 53)
    np.testing.assert_allclose(got, exp, atol=1e-6)


@pytest.mark.parametrize("shape,shifts,neighbor", [
    ((2, 96, 80, 16), [1, 3, 5, 9, 27], 4),
    ((1, 64, 70, 8), [1, 3], 8),       # ox > 0 offsets
    ((1, 45, 61, 16), [1, 3, 5, 9, 27], 4),  # non-divisible H and W
])
def test_fused_affinity_2d_cpu_matches_pallas_interpret(shape, shifts, neighbor):
    e = _emb(shape, 2)
    offsets = multi_offset(shifts, neighbor)
    before = fused_affinity_2d.launches
    got = fused_affinity_2d(torch.from_numpy(e), offsets).numpy()
    exp = np.asarray(jax_fused_affinity_2d(
        jnp.asarray(e), tuple(map(tuple, offsets)), 64, True))
    np.testing.assert_allclose(got, exp, atol=1e-5)
    assert fused_affinity_2d.launches == before  # CPU runs the plain version


def test_fused_affinity_2d_takes_strided_view():
    e = _emb((2, 20, 24, 16), 3)
    offsets = multi_offset([1, 3, 5], 8)
    nchw = torch.from_numpy(e).permute(0, 3, 1, 2).contiguous()
    got = fused_affinity_2d(nchw.permute(0, 2, 3, 1), offsets)
    exp = fused_affinity_2d(torch.from_numpy(e), offsets)
    # the CPU reduction order follows the memory layout: f32 rounding only
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=1e-6)


def test_affinity_2d_plain_bf16_computes_in_f32():
    e = _emb((1, 30, 34, 16), 4)
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    eb = torch.from_numpy(e).to(torch.bfloat16)
    got = affinity_2d_plain(eb, offsets)
    assert got.dtype == torch.bfloat16
    exp = embedding_to_affinity_2d(eb.float(), offsets, padding="valid")
    # bf16 output rounding: half an ulp at |a| <= 1 is 2^-9
    np.testing.assert_allclose(got.float().numpy(), exp.numpy(), atol=2 ** -8)


def test_fused_affinity_2d_rejects_bad_input():
    with pytest.raises(ValueError):
        fused_affinity_2d(torch.zeros(4, 5, 16), [[-1, 0]])
    with pytest.raises(ValueError):
        embedding_to_affinity_2d(torch.zeros(1, 4, 5, 16), [[-1, 0]],
                                 padding="reflect")


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    from pixel_embedded_affinity_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_without_jax():
    """The port, its serving paths (2D, the fast forward and its kernels'
    wrappers included, and 3D) and its training paths (2D and 3D, the BBBC
    device sampler too) import with jax, flax, optax, the
    JAX package and the lazily-imported optional modules all blocked, and
    the synthetic nuclei need none of them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'pixel_embedded_affinity_tpu',\n"
        "          'msgpack', 'h5py', 'cv2', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import pixel_embedded_affinity_torch.inference\n"
        "import pixel_embedded_affinity_torch.infer\n"
        "import pixel_embedded_affinity_torch.checkpoint\n"
        "import pixel_embedded_affinity_torch.data\n"
        "import pixel_embedded_affinity_torch.convert\n"
        "import pixel_embedded_affinity_torch.train\n"
        "import pixel_embedded_affinity_torch.utils\n"
        "import pixel_embedded_affinity_torch.ops.losses\n"
        "import pixel_embedded_affinity_torch.ops.targets\n"
        "import pixel_embedded_affinity_torch.data.consistency\n"
        "import pixel_embedded_affinity_torch.data.device_aug\n"
        "import pixel_embedded_affinity_torch.data.provider\n"
        "import pixel_embedded_affinity_torch.data.ac3ac4\n"
        "import pixel_embedded_affinity_torch.infer.inference3d\n"
        "import pixel_embedded_affinity_torch.parallel.tiling\n"
        "import pixel_embedded_affinity_torch.models.fast_forward3d\n"
        "import pixel_embedded_affinity_torch.models.resnet_embed\n"
        "import pixel_embedded_affinity_torch.models.unet3d_mala\n"
        "import pixel_embedded_affinity_torch.ops.losses_extra\n"
        "from pixel_embedded_affinity_torch.convert import (\n"
        "    resnet_embedding_from_flax, unet3d_mala_from_flax)\n"
        "import pixel_embedded_affinity_torch.models.unet3d_pni\n"
        "import pixel_embedded_affinity_torch.ops.emb2aff3d_cuda\n"
        "import pixel_embedded_affinity_torch.ops.emb2aff_cuda\n"
        "import pixel_embedded_affinity_torch.models.common\n"
        "import pixel_embedded_affinity_torch.train.train_step\n"
        "import pixel_embedded_affinity_torch.train.loop\n"
        "from pixel_embedded_affinity_torch.train import TrainStep3D, validate_3d\n"
        "from pixel_embedded_affinity_torch.ops import fused_cross_affinity_3d\n"
        "import pixel_embedded_affinity_torch.postproc.watershed\n"
        "import pixel_embedded_affinity_torch.postproc.agglomerate\n"
        "import pixel_embedded_affinity_torch.postproc.multicut\n"
        "import pixel_embedded_affinity_torch.data.bbbc\n"
        "import pixel_embedded_affinity_torch.data.device_data\n"
        "import pixel_embedded_affinity_torch.data.device_warp\n"
        "import pixel_embedded_affinity_torch.metrics.bbbc\n"
        "from pixel_embedded_affinity_torch.ops import fused_cross_affinity_2d\n"
        "from pixel_embedded_affinity_torch.data import synthesize_nuclei\n"
        "import pixel_embedded_affinity_torch.ops.s2d\n"
        "import pixel_embedded_affinity_torch.ops.conv3x3_cuda\n"
        "import pixel_embedded_affinity_torch.ops.s2d_block_cuda\n"
        "from pixel_embedded_affinity_torch.models import build_fast_resunet_forward\n"
        "from pixel_embedded_affinity_torch.infer import fast_affinities\n"
        "import pixel_embedded_affinity_torch.ops.tile_copy_cuda\n"
        "import pixel_embedded_affinity_torch.utils.profile_arrange\n"
        "import pixel_embedded_affinity_torch.train.__main__\n"
        "import pixel_embedded_affinity_torch.train.optim\n"
        "import pixel_embedded_affinity_torch.data.augment2d\n"
        "from pixel_embedded_affinity_torch.data.cvppp import CVPPPTrain\n"
        "from pixel_embedded_affinity_torch.data.bbbc import BBBCTrain\n"
        "from pixel_embedded_affinity_torch.data.ac3ac4 import AC3AC4Train\n"
        "from pixel_embedded_affinity_torch.data.device_data import (\n"
        "    sample_cvppp_batch, sample_ac3ac4_batch, load_ac3ac4_arrays)\n"
        "synthesize_nuclei(1, 40, 48)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_do_not_import_jax():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|pixel_embedded_affinity_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "pixel_embedded_affinity_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    # the training CLI, the optimizers and the host samplers are scanned too
    port = os.path.join(REPO, "pixel_embedded_affinity_torch")
    for rel in ("train/__main__.py", "train/optim.py", "train/checkpoint.py",
                "data/augment2d.py", "data/cvppp.py", "data/bbbc.py", "data/ac3ac4.py",
                "data/consistency.py", "ops/affinity_np.py", "models/fast_forward3d.py",
                "models/resnet_embed.py", "models/unet3d_mala.py", "ops/losses_extra.py",
                "parallel/tiling.py"):
        assert os.path.join(port, rel) in files, rel
    for path in files:
        with open(path) as f:
            bad = [ln for ln in f if pat.match(ln)]
        assert not bad, (path, bad)
