"""The port's device-resident AC3/AC4 sampler vs the JAX package's, on the
CPU.

Same volumes, made with numpy from a seed (``synthesize_volume``, or an
HDF5 pair written here), through both packages. Where a JAX function takes
a key, its parameters are drawn here with ``jax.random`` from the key
splits the JAX function makes, and fed to the port's parameterised
function:

* bit-equal: ``seg_widen_border``, the loader (files, and a volume thinner
  than the crop), ``_flip_rule4``, ``_rot90_xy``, ``_misalign_single``,
  ``_missing_section_single``, the elastic warp's labels and the whole
  ``_augs_mix`` chain's labels;
* the elastic warp's image and the chain's image within 1e-6, and
  ``_intensity_3d_single`` within 1e-6 (float32 pow of two libraries);
* the sampler by its contract (shapes, types, ranges, label ids, the plain
  centre crop, the seeding) and by rates over 4000 draws: the aug gate at
  0.5, each link's gate, the EM artefact at 0.2, its two kinds at 0.5;
* ``train()`` on the ac3ac4 preset from the device-resident sampler: a
  resumed run ends bit-equal to an uninterrupted one; the preset equals
  JAX's field for field but for the TPU's serving choices.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

import jax
import jax.numpy as jnp

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.data import device_data as jdd
from pixel_embedded_affinity_tpu.data import device_warp as jdw
from pixel_embedded_affinity_tpu.ops.affinity_np import seg_widen_border as jax_widen

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import AC3AC4ValidVolume, synthesize_volume
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.ops.affinity_np import seg_widen_border
from pixel_embedded_affinity_torch.train import load_checkpoint, train

T = torch.from_numpy
FILTERS = (4, 6, 8, 12, 16)


def _vol(d=8, h=40, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((d, h, w)).astype(np.float32),
            rng.integers(0, 12, (d, h, w)).astype(np.int32))


@pytest.mark.parametrize("ndim", [2, 3])
def test_seg_widen_border_matches_jax(ndim):
    _, lab = synthesize_volume(6, 48, 40, n_cells=12, seed=1)
    lab = lab[2] if ndim == 2 else lab
    lab = np.where(np.random.default_rng(0).random(lab.shape) < 0.05, 0, lab)
    got = seg_widen_border(lab, tsz_h=1)
    np.testing.assert_array_equal(got, jax_widen(lab, tsz_h=1))
    assert (got == 0).sum() > (lab == 0).sum()


@pytest.fixture(scope="module")
def h5_folder(tmp_path_factory):
    raw, lab = synthesize_volume(d=24, h=72, w=72, n_cells=15, seed=0)
    folder = str(tmp_path_factory.mktemp("ac4"))
    for name, arr in (("AC4_inputs.h5", raw), ("AC4_labels.h5", lab)):
        with h5py.File(os.path.join(folder, name), "w") as f:
            f.create_dataset("main", data=arr)
    return folder, raw, lab


@pytest.mark.parametrize("train_split", [20, 10], ids=["split", "thinner_than_crop"])
def test_load_ac3ac4_arrays_matches_jax(h5_folder, train_split):
    folder, raw, lab = h5_folder
    got = dd.load_ac3ac4_arrays(folder, "ac4", train_split=train_split, crop_z=18)
    exp = jdd.load_ac3ac4_arrays(folder, "ac4", train_split=train_split, crop_z=18)
    assert got[0].shape[0] == max(train_split, 18)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    in_memory = dd.load_ac3ac4_arrays("", train_split=train_split, crop_z=18,
                                      arrays=(raw, lab))
    for g, m in zip(got, in_memory):
        np.testing.assert_array_equal(g, m)


def test_flip_rule4_matches_jax():
    img, lab = _vol()
    for bits in range(16):
        rule = [(bits >> i) & 1 for i in range(4)]
        for a in (img, lab):
            exp = np.asarray(jdd._flip_rule4(jnp.asarray(a), jnp.asarray(rule, jnp.int32)))
            np.testing.assert_array_equal(dd._flip_rule4(T(a), rule).numpy(), exp)


def test_rot90_xy_matches_jax():
    img, lab = _vol()
    for k in range(4):
        for a in (img, lab):
            exp = np.asarray(jdd._rot90_xy(jnp.asarray(a), jnp.int32(k)))
            np.testing.assert_array_equal(dd._rot90_xy(T(a), k).numpy(), exp)


def _misalign_draws(key, d):
    kz, ky, kx = jax.random.split(key, 3)
    return (int(jax.random.randint(kz, (), 1, d)), int(jax.random.randint(ky, (), -10, 11)),
            int(jax.random.randint(kx, (), -10, 11)))


@pytest.mark.parametrize("seed", range(4))
def test_misalign_matches_jax(seed):
    img, lab = _vol()
    key = jax.random.PRNGKey(seed)
    exp_i, exp_l = jdd._misalign_single(jnp.asarray(img), jnp.asarray(lab), key)
    got_i, got_l = dd._misalign_single(T(img), T(lab), *_misalign_draws(key, img.shape[0]))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(exp_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(exp_l))


def _missing_draws(key, vol):
    """The sections ``jdd._missing_section_single`` fills from ``key``."""
    d = vol.shape[0]
    kn, kz1, kz2, kf1, kf2, ku1, ku2 = jax.random.split(key, 7)
    n = int(jax.random.randint(kn, (), 1, 3))
    z1 = int(jax.random.randint(kz1, (), 0, d))
    z2 = int(jax.random.randint(kz2, (), 0, d - 1))
    z2 += z2 >= z1
    sections = []
    for z, kf, ku in ((z1, kf1, ku1), (z2, kf2, ku2))[:n]:
        noise = bool(jax.random.bernoulli(kf))
        fill = np.array(jax.random.uniform(ku, vol.shape, jnp.float32)[z])
        sections.append((z, T(fill) if noise else None))
    return sections


@pytest.mark.parametrize("seed", range(6))
def test_missing_section_matches_jax(seed):
    img, _ = _vol()
    key = jax.random.PRNGKey(seed)
    exp = np.asarray(jdd._missing_section_single(jnp.asarray(img), key))
    got = dd._missing_section_single(T(img), _missing_draws(key, img))
    np.testing.assert_array_equal(got.numpy(), exp)


def _intensity_draws(key, d):
    """(c, b, g) of ``jdd._intensity_3d_single``: per slice ((D, 1, 1)
    tensors) or for the whole volume (floats)."""
    km, k2, k3 = jax.random.split(key, 3)
    if bool(jax.random.bernoulli(km)):
        c, b, g = jax.vmap(jdd._grayscale_params)(jax.random.split(k2, d))
        return tuple(T(np.array(v, np.float32).reshape(d, 1, 1)) for v in (c, b, g))
    return tuple(float(v) for v in jdd._grayscale_params(k3))


@pytest.mark.parametrize("seed", range(4))
def test_intensity_3d_matches_jax(seed):
    img, _ = _vol()
    key = jax.random.PRNGKey(seed)
    exp = np.asarray(jdd._intensity_3d_single(jnp.asarray(img), key))
    got = dd._intensity_3d_single(T(img), *_intensity_draws(key, img.shape[0])).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def _elastic_draws(key, h, w):
    return tuple(T(np.array(a)) for a in jdw.elastic_field(key, h, w, 16.0, 4.0))


def test_elastic_xy_matches_jax():
    img, lab = _vol()
    key = jax.random.PRNGKey(5)
    exp_i, exp_l = jdd._elastic_xy_single(jnp.asarray(img), jnp.asarray(lab), key)
    got_i, got_l = dd._elastic_xy_single(T(img), T(lab), *_elastic_draws(key, 40, 40))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(exp_i), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(exp_l))


def _jax_mix_params(key, img):
    """The parameters ``jdd._augs_mix_jax`` draws from ``key``, in the
    port's form (:func:`dd._augs_mix_draw`'s output)."""
    d, h, w = img.shape
    kg1, kf, kg2, kk, kg3, ke, kg4, ki, kg5, kg6, kem = jax.random.split(key, 11)
    u = lambda k: float(jax.random.uniform(k))  # noqa: E731
    rule = [int(v) for v in jax.random.randint(kf, (4,), 0, 2)]
    k = int(jax.random.randint(kk, (), 0, 4)) if u(kg2) > 0.5 else 0
    em = None
    if u(kg5) < 0.2:
        k_ms, k_ma = jax.random.split(kem)
        em = (("missing", _missing_draws(k_ms, img)) if u(kg6) < 0.5
              else ("misalign", _misalign_draws(k_ma, d)))
    return {"flip": rule if u(kg1) > 0.5 else None, "rot": k,
            "elastic": _elastic_draws(ke, h, w) if u(kg3) < 0.5 else None,
            "gray": _intensity_draws(ki, d) if u(kg4) < 0.5 else None, "em": em}


def _first_seed(want):
    img, _ = _vol()
    for s in range(200):
        p = _jax_mix_params(jax.random.PRNGKey(s), img)
        if want(p):
            return s
    raise AssertionError("no seed")


@pytest.mark.parametrize("case", ["missing", "misalign", "geometry"])
def test_augs_mix_matches_jax_at_its_draws(case):
    """The chain at JAX's draws, for a key that draws each EM artefact
    and one that draws flip, rot90, elastic and the intensity together."""
    want = {"missing": lambda p: p["em"] is not None and p["em"][0] == "missing",
            "misalign": lambda p: p["em"] is not None and p["em"][0] == "misalign",
            "geometry": lambda p: (p["flip"] is not None and p["rot"] and p["elastic"]
                                   is not None and p["gray"] is not None)}[case]
    img, lab = _vol()
    key = jax.random.PRNGKey(_first_seed(want))
    exp_i, exp_l = jdd._augs_mix_jax(jnp.asarray(img), jnp.asarray(lab), key)
    got_i, got_l = dd._augs_mix(T(img), T(lab), _jax_mix_params(key, img))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(exp_i), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(exp_l))


@pytest.fixture(scope="module")
def arrays():
    return dd.load_ac3ac4_arrays("", train_split=20,
                                 arrays=synthesize_volume(20, 72, 72, n_cells=15, seed=3))


def test_sampler_contract(arrays):
    raw, labels = (T(a) for a in arrays)
    kw = dict(crop_size=(12, 32, 32), padding=10)
    batch = dd.sample_ac3ac4_batch(raw, labels, dd.sampler_generator(555, 3), 3, **kw)
    assert batch["image"].shape == (3, 12, 32, 32, 1) and batch["image"].dtype == torch.float32
    assert batch["seg"].shape == (3, 12, 32, 32) and batch["seg"].dtype == torch.int32
    im = batch["image"].numpy()
    assert im.min() >= 0.0 and im.max() <= 1.0
    assert set(np.unique(batch["seg"].numpy())) <= set(np.unique(arrays[1])) | {0}
    again = dd.sample_ac3ac4_batch(raw, labels, dd.sampler_generator(555, 3), 3, **kw)
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    other = dd.sample_ac3ac4_batch(raw, labels, dd.sampler_generator(555, 4), 3, **kw)
    assert not torch.equal(batch["image"], other["image"])
    # no augmentation: the centre of the drawn crop, /255
    p = dd._ac3ac4_params(dd.sampler_generator(1, 1), arrays[1].shape, (12, 52, 52))
    plain = dd._ac3ac4_sample(raw, labels, {**p, "aug": False}, **kw)
    z, y, x = p["corner"]
    np.testing.assert_allclose(plain["image"][..., 0].numpy(),
                               arrays[0][z:z + 12, y + 10:y + 42, x + 10:x + 42] / 255.0,
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(plain["seg"].numpy(),
                                  arrays[1][z:z + 12, y + 10:y + 42, x + 10:x + 42])


def test_draws_fire_at_their_rates():
    """4000 draws: the aug gate at 0.5 and, within _augs_mix, flip, rot90,
    elastic and intensity at 0.5 each, the intensity per slice half the
    time, an EM artefact at 0.2 split evenly between its kinds, 1 or 2
    distinct sections; bounds 4.5 standard deviations."""
    n, d = 4000, 18
    gen = dd.sampler_generator(0, 0)
    draws = [dd._ac3ac4_params(gen, (80, 400, 400), (d, 260, 260)) for _ in range(n)]
    mix = [p["mix"] for p in draws]

    def rate(xs, p):
        xs = np.asarray(xs, np.float64)
        assert abs(xs.mean() - p) < 4.5 * np.sqrt(p * (1 - p) / len(xs)), (xs.mean(), p)

    rate([p["aug"] for p in draws], 0.5)
    rate([m["flip"] is not None for m in mix], 0.5)
    rate([m["rot"] > 0 for m in mix], 0.5 * 0.75)
    rate([m["elastic"] for m in mix], 0.5)
    rate([m["gray"] is not None for m in mix], 0.5)
    rate([m["gray"] == "slices" for m in mix if m["gray"] is not None], 0.5)
    em = [m["em"] for m in mix]
    rate([e is not None for e in em], 0.2)
    rate([e[0] == "missing" for e in em if e is not None], 0.5)
    for kind, arg in (e for e in em if e is not None):
        if kind == "missing":
            zs = [z for z, _ in arg]
            assert len(set(zs)) == len(zs) and 1 <= len(zs) <= 2 and 0 <= min(zs)
            assert max(zs) < d
        else:
            z0, dy, dx = arg
            assert 1 <= z0 < d and -10 <= dy <= 10 and -10 <= dx <= 10
    corners = np.array([p["corner"] for p in draws])
    assert corners.min() == 0 and (corners.max(axis=0) == (80 - d, 140, 140)).all()


def _setup(tmp_path, name, **train_kw):
    return load_config("ac3ac4", {
        "model": {"filters": FILTERS},
        "train": {"display_freq": 1, "valid_freq": 3, "save_freq": 2, **train_kw},
        "data": {"crop_size": (8, 32, 32), "padding_3d": 10, "train_split": 12},
        "save_path": str(tmp_path / name)})


def test_train_device_resident_resumes_exactly(tmp_path):
    arrays = dd.load_ac3ac4_arrays("", train_split=12, crop_z=8,
                                   arrays=synthesize_volume(14, 64, 64, n_cells=10, seed=1))
    valid = AC3AC4ValidVolume("", arrays=synthesize_volume(10, 64, 64, n_cells=8, seed=2))
    cfg = _setup(tmp_path, "a")
    assert cfg.data.device_resident
    state, history = train(cfg, max_iters=3, data_override=(arrays, valid), device="cpu")
    assert state.step == 3 and {"valid/waterz_voi", "valid/affs_mse"} <= set(history[0])
    assert all(np.isfinite(v) for v in history[0].values())
    run = os.path.join(cfg.save_path, cfg.name)
    cfg_b = _setup(tmp_path, "b", resume=True, if_valid=False)
    run_b = os.path.join(cfg_b.save_path, cfg_b.name)
    os.makedirs(run_b)
    shutil.copy(os.path.join(run, "model-000002.ckpt"), run_b)
    train(cfg_b, max_iters=3, data_override=(arrays, valid), device="cpu")
    a = load_checkpoint(os.path.join(run, "model-000003.ckpt"))
    b = load_checkpoint(os.path.join(run_b, "model-000003.ckpt"))
    # the msgpack trees (params, batch_stats, opt_state, step), bit for bit
    la, lb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.array_equal(x, y), jax.tree_util.keystr(p)


def test_ac3ac4_preset_matches_jax():
    port, ref = load_config("ac3ac4"), jax_load_config("ac3ac4")
    assert port.name == ref.name and port.save_path == ref.save_path
    n = 0
    for sec in ("model", "train", "data"):
        p, r = getattr(port, sec), getattr(ref, sec)
        for k in vars(p):
            if k in ("dtype", "bf16_tiled_infer", "fast_tiled_infer"):  # the TPU's choices
                continue
            assert getattr(p, k) == getattr(r, k), f"{sec}.{k}"
            n += 1
    assert n >= 40 and port.data.device_resident
    assert (port.data.train_split, port.data.padding_3d) == (80, 50)
