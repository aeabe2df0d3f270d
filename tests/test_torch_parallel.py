"""The port's ``parallel/`` on the CPU: the mesh, its shardings and
``multihost`` against the JAX package's names and contracts, the
double-buffered device copy, the tiled engine split over 2 gloo ranks,
the resident sampler's and the EMA view's shards, and the training CLI's
``--distributed`` at 2 ranks.

Ranks are spawned processes that join one gloo group through a file
(``torch_dp_ranks.py``). Without a process group a :class:`Mesh` of any
rank and size can be built by hand: the shardings and the checks of a
batch that does not split read nothing else.

* ``TiledInference3D(mesh=)`` at 2 ranks, batch 8 (the last batch of 3
  split 2 + 1) and batch 2 (the last batch of 1: rank 1 predicts none of
  it): every rank's canvas the same, within 1e-5 of JAX's meshed ``run``
  on the conftest's 8 devices (JAX's own bound for ``run``,
  tests/test_tiling.py) and 1e-6 of the port's one-process canvas.
* the resident sampler's batches and their EMA views (CVPPP with noise and
  blur, AC3/AC4) at 2 ranks: the shards, concatenated in rank order, are
  the one-process batch bit for bit.
* ``main(["--distributed", "--device", "cpu", ...])``: 2 steps of a small
  cvppp run from the device sampler with validation; rank 0 alone writes
  the checkpoint and the logs, the ranks end bit-equal, and at
  ``tests/test_dp_parity.py``'s TOL of the one-process run. The host
  sampler's path (targets and EMA view built on the host, each rank its
  own samples, gathered into the global batch) trains 2 steps, the ranks
  bit-equal.
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

from pixel_embedded_affinity_tpu.parallel import get_mesh as jax_get_mesh
from pixel_embedded_affinity_tpu.parallel import tiling as jax_tiling

from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_volume
from pixel_embedded_affinity_torch.data.consistency import normalize_imagenet
from pixel_embedded_affinity_torch.data.cvppp import PAD, CVPPPTrain
from pixel_embedded_affinity_torch.data.provider import device_prefetch, to_device
from pixel_embedded_affinity_torch.parallel import (
    Mesh, TiledInference3D, batch_sharding, get_mesh, global_batch, initialize,
    is_multiprocess, replicated_sharding, to_global)
from pixel_embedded_affinity_torch.train import train

import torch_dp_ranks as R
from synth import blob_labels

TOL = dict(rtol=3e-3, atol=2.5e-4)  # tests/test_dp_parity.py's
CPU = torch.device("cpu")
TILES_VOLUME = (20, 48, 48)
TILES = dict(crop_size=(12, 32, 32), stride=(6, 16, 16), padding=(2, 8, 8))  # 27 tiles
CLI_ARGS = ["-c", "cvppp", "-i", "2", "--device", "cpu", "-o",
            f"model.filters={R.FILTERS}", "data.size=64", "train.batch_size=4",
            "train.display_freq=1", "train.valid_freq=2", "train.save_freq=100"]


def _fake_mesh(rank, size):
    """A mesh of ``size`` ranks seen from ``rank``, with no process group:
    enough for the shardings and the batch checks."""
    return Mesh(None, rank, size, CPU)


def _leaves(n, seed):
    """(image (50, 20, 3) in [0, 1], label) pairs, padded to 64x64."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lab = blob_labels(50, 50, grid=3, radius=6, seed=seed + i)[:, 15:35]
        img = rng.random((50, 20, 3)).astype(np.float32) * 0.3
        img[lab > 0] += 0.5
        out.append((img, lab))
    return out


def _cvppp_valid():
    return [{"image": normalize_imagenet(np.pad(img, PAD + ((0, 0),), mode="reflect")),
             "seg": np.pad(lab, PAD)} for img, lab in _leaves(1, 7)]


def _sampler_arrays(kind):
    if kind == "3d":
        return dd.load_ac3ac4_arrays("", train_split=12, crop_z=8,
                                     arrays=synthesize_volume(14, 64, 64, n_cells=10, seed=1))
    return dd.pack_cvppp_arrays(_leaves(3, 0))


# --- the mesh, shardings and multihost, in this process -------------------------------

def test_mesh_without_a_process_group_is_one_rank():
    mesh = get_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    assert get_mesh([torch.device("cpu")]) == mesh and not is_multiprocess()
    with pytest.raises(ValueError, match="one device a process"):
        get_mesh(["cpu", "cpu"])


def test_shardings_split_the_leading_axis_like_jax():
    x = np.arange(8 * 3).reshape(8, 3).astype(np.float32)
    for size in (1, 2, 4):
        parts = [to_global(x, batch_sharding(_fake_mesh(r, size))) for r in range(size)]
        assert all(p.shape == (8 // size, 3) for p in parts)
        assert torch.equal(torch.cat(parts), torch.from_numpy(x))
        full = to_global(x, replicated_sharding(_fake_mesh(size - 1, size)))
        assert torch.equal(full, torch.from_numpy(x))
    batch = {"a": x, "b": torch.arange(8)}
    got = global_batch(batch, batch_sharding(_fake_mesh(1, 2)))
    assert torch.equal(got["a"], torch.from_numpy(x[4:])) and torch.equal(got["b"],
                                                                           torch.arange(4, 8))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        to_global(x, batch_sharding(_fake_mesh(0, 3)))
    with pytest.raises(ValueError, match="axis"):
        batch_sharding(_fake_mesh(0, 2), axis_name="model")


def test_initialize_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_mesh()


def test_a_batch_that_does_not_split_raises():
    mesh = _fake_mesh(0, 2)
    cfg = R.sampler_config("cvppp")
    cfg.train.batch_size = 5
    with pytest.raises(ValueError, match="batch_size=5 does not divide over 2 ranks"):
        train(cfg, max_iters=1, data_override=((None, None), []), mesh=mesh)
    with pytest.raises(ValueError, match="batch_size=5 does not divide over 2 ranks"):
        TiledInference3D(batch_size=5, mesh=mesh)


# --- device_prefetch ------------------------------------------------------------------

def _host_batches(n):
    rng = np.random.default_rng(0)
    return [{"image": rng.random((4, 8, 8, 3)).astype(np.float32),
             "seg": rng.integers(0, 5, (4, 8, 8)).astype(np.int32)} for _ in range(n)]


def test_device_prefetch_yields_to_devices_batches_in_order():
    batches = _host_batches(5)
    pulled = []

    def source():
        for b in batches:
            pulled.append(1)
            yield b

    it = device_prefetch(source(), device="cpu")
    first = next(it)
    assert len(pulled) == 3  # as JAX's: the next 2 are in flight while the first is used
    got = [first] + list(it)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        exp = to_device(b, "cpu")
        assert set(g) == set(exp) and all(torch.equal(g[k], exp[k]) for k in exp)
    assert list(device_prefetch(iter([]), device="cpu")) == []


def test_device_prefetch_copies_the_ranks_shard():
    batches = _host_batches(3)
    for rank in range(2):
        got = list(device_prefetch(iter(batches), batch_sharding(_fake_mesh(rank, 2))))
        for g, b in zip(got, batches):
            assert torch.equal(g["image"], torch.from_numpy(b["image"][2 * rank:2 * rank + 2]))
            assert torch.equal(g["seg"], torch.from_numpy(b["seg"][2 * rank:2 * rank + 2]))


# --- 2 gloo ranks ---------------------------------------------------------------------

def _cli_case(tmp, extra):
    return {"what": "cli", "argv": CLI_ARGS + [f"save_path={tmp}/rank{{rank}}", *extra,
                                              "--distributed"]}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks2")
    volume = np.random.default_rng(7).random(TILES_VOLUME).astype(np.float32)
    arrays, valid = dd.pack_cvppp_arrays(_leaves(3, 0)), _cvppp_valid()
    host = CVPPPTrain(size=64, pairs=_leaves(3, 0), seed=4)
    cases = {
        "tiles-8": {"what": "tiles", "volume": volume, "engine": dict(TILES, batch_size=8)},
        "tiles-2": {"what": "tiles", "volume": volume, "engine": dict(TILES, batch_size=2)},
        "sampler-cvppp": {"what": "sampler", "kind": "cvppp",
                          "arrays": _sampler_arrays("cvppp")},
        "sampler-3d": {"what": "sampler", "kind": "3d", "arrays": _sampler_arrays("3d")},
        "cli": dict(_cli_case(tmp, []), arrays=arrays, valid=valid),
        "cli-host": dict(_cli_case(tmp, ["name=host", "data.device_resident=False",
                                         "data.device_gt=False", "data.device_ema=False",
                                         "train.num_workers=1", "train.if_valid=False"]),
                         arrays=host, valid=[]),
    }
    ranks = R.Ranks(2, tmp, cases)
    return tmp, cases, ranks


def test_tiled_engine_splits_each_batch_over_the_ranks(two_ranks):
    _, cases, ranks = two_ranks
    res = ranks.results()
    vol = cases["tiles-8"]["volume"]

    def jax_predict(tiles):  # (B, d, h, w, 1) -> (B, 3, d, h, w), as R._tiles_predict
        t = tiles[..., 0]
        return jnp.stack([t * 2.0, jnp.flip(t, axis=-1), jnp.sin(3 * t) + t * t], axis=1)

    meshed = jax_tiling.TiledInference3D(**TILES, batch_size=8, mesh=jax_get_mesh()).run(
        vol, jax_predict, n_channels=3)
    sizes = {"tiles-8": ([4, 4, 4, 2], [4, 4, 4, 1]), "tiles-2": ([1] * 14, [1] * 13)}
    for name in ("tiles-8", "tiles-2"):
        one, one_sizes = R.tiled_canvas(vol, cases[name]["engine"])
        (c0, s0), (c1, s1) = res[0][name], res[1][name]
        assert (s0, s1) == sizes[name] and sum(s0 + s1) == sum(one_sizes) == 27
        assert np.array_equal(c0, c1) and c0.shape == (3,) + TILES_VOLUME
        np.testing.assert_allclose(c0, one, atol=1e-6, rtol=0)
        np.testing.assert_allclose(c0, np.asarray(meshed), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["cvppp", "3d"])
def test_sampler_and_ema_shards_make_the_one_process_batch(two_ranks, kind):
    _, cases, ranks = two_ranks
    res = ranks.results()
    exp = R.sampled_shards(kind, cases[f"sampler-{kind}"]["arrays"])
    for s, batch in enumerate(exp):
        assert {"ema_image", "rules"} <= set(batch)
        for k, v in batch.items():
            got = torch.cat([res[r][f"sampler-{kind}"][s][k] for r in range(2)])
            assert torch.equal(got, v), (s, k)


def test_cli_distributed_trains_on_two_ranks(two_ranks):
    tmp, cases, ranks = two_ranks
    res = ranks.results()
    r0, r1 = res[0]["cli"], res[1]["cli"]
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    run0, run1 = tmp / "rank0" / "cvppp", tmp / "rank1" / "cvppp"
    assert sorted(os.listdir(run0)) == ["log", "model-000002.ckpt", "valid"]
    assert not run1.exists()  # rank 1 writes no checkpoint, log or montage
    one = R.cli_run(CLI_ARGS + [f"save_path={tmp}/one"], cases["cli"]["arrays"],
                    cases["cli"]["valid"])
    for k, v in one.items():
        if v.is_floating_point():
            np.testing.assert_allclose(r0[k].numpy(), v.numpy(), err_msg=k, **TOL)
    h0, h1 = res[0]["cli-host"], res[1]["cli-host"]
    assert all(torch.equal(h0[k], h1[k]) for k in h0)
    assert all(torch.isfinite(v).all() for v in h0.values() if v.is_floating_point())
    assert sorted(os.listdir(tmp / "rank0" / "host")) == ["log", "model-000002.ckpt"]
    assert not (tmp / "rank1" / "host").exists()
