"""The port's tiled engine against the JAX package's ``TiledInference3D``
on the CPU: ``run`` against JAX's ``run`` and its batches (a mesh: in
tests/test_torch_parallel.py). A content-dependent predictor (each output
channel a different function of the voxel, one of them mirrored in x) goes
through both engines on the same seeded volume, at the geometries of the
JAX package's own tests (tests/test_tiling.py), regular and clamped grids
alike.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax.numpy as jnp

from pixel_embedded_affinity_tpu.parallel import tiling as jax_tiling

from pixel_embedded_affinity_torch.parallel import TiledInference3D, regular_grid_dims

ATOL = 1e-6
# (volume shape, engine arguments, regular padded grid?) from
# tests/test_tiling.py's device-resident, dense-strip and fallback cases
GEOMETRIES = {
    "regular-27": ((20, 48, 48), dict(crop_size=(12, 32, 32), stride=(6, 16, 16),
                                      padding=(2, 8, 8), batch_size=4), True),
    "clamped-z": ((16, 40, 40), dict(crop_size=(12, 24, 24), stride=(6, 12, 12),
                                     padding=(2, 4, 4), batch_size=2), False),
    "regular-196": ((16, 56, 56), dict(crop_size=(8, 16, 16), stride=(4, 8, 8),
                                       padding=(2, 4, 4), batch_size=4), True),
    "irregular-x": ((13, 40, 44), dict(crop_size=(8, 16, 16), stride=(4, 8, 12),
                                       padding=(2, 4, 4), batch_size=4), False),
    "clamped-z-batch-8": ((12, 40, 40), dict(crop_size=(6, 16, 16), stride=(4, 8, 8),
                                             padding=(2, 4, 4), batch_size=8), False),
}


def _volume(shape, seed=7):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _jax_predict(tiles):  # (B, d, h, w, 1) -> (B, 3, d, h, w)
    t = tiles[..., 0]
    return jnp.stack([t * 2.0, jnp.flip(t, axis=-1), jnp.sin(3 * t) + t * t], axis=1)


def _torch_predict(tiles):  # (B, 1, d, h, w) -> (B, 3, d, h, w)
    t = tiles[:, 0]
    return torch.stack([t * 2.0, torch.flip(t, dims=(-1,)), torch.sin(3 * t) + t * t], dim=1)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_run_matches_jax(name):
    shape, kw, regular = GEOMETRIES[name]
    vol = _volume(shape)
    padded = tuple(v + 2 * p for v, p in zip(shape, kw["padding"]))
    assert (regular_grid_dims(padded, kw["crop_size"], kw["stride"]) is not None) == regular
    exp = jax_tiling.TiledInference3D(**kw).run(vol, _jax_predict, n_channels=3)
    got = TiledInference3D(**kw).run(vol, _torch_predict, 3, device="cpu")
    assert got.shape == exp.shape == (3,) + shape and got.dtype == np.float32
    np.testing.assert_allclose(got, exp, atol=ATOL)


def test_run_predicts_each_tile_once():
    """27 tiles at batch 4: six full batches and a short one of 3, each
    tile predicted once, as JAX's run does."""
    shape, kw, _ = GEOMETRIES["regular-27"]
    batches = []

    def predict(tiles):
        batches.append(tiles.shape[0])
        return _torch_predict(tiles)

    TiledInference3D(**kw).run(_volume(shape), predict, 3, device="cpu")
    assert batches == [4] * 6 + [3]
