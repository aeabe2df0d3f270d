"""Train checkpoints through ``torch.distributed.checkpoint`` (DCP), the
port's counterpart of the JAX package's orbax backend
(``save_checkpoint_orbax`` / ``load_checkpoint_orbax``), on the CPU.

* The tree the port restores from its DCP directory equals, leaf for leaf
  and in dtype, the tree JAX's ``load_checkpoint_orbax`` restores from
  JAX's ``save_checkpoint_orbax`` of the same state (orbax writes tuples
  as lists and stateless links as None; the port's tree is Flax's
  ``to_state_dict`` form, dicts keyed "0", "1", ... and ``{}``, as its
  msgpack files hold it).
* A resume from DCP equals a resume from msgpack, bit for bit, and the
  next optimizer step from each too.
* Two gloo ranks (this file run as a script, one process each) save one
  directory, each tensor written once, and load it back; the tree equals
  the single process's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
from pixel_embedded_affinity_torch.train import (TrainState, load_checkpoint,
                                                 load_checkpoint_dcp, make_optimizer, restore,
                                                 save_checkpoint, save_checkpoint_dcp)

FILTERS = (4, 6, 8, 12, 16)
HERE = os.path.dirname(os.path.abspath(__file__))


def _cfg(**train):
    return load_config("cvppp", {"model": {"filters": FILTERS}, "train": train})


def _stepped_state(cfg, seed: int = 0, steps: int = 2) -> TrainState:
    """A port TrainState after ``steps`` optimizer steps on a seeded loss,
    so every moment is nonzero."""
    torch.manual_seed(seed)
    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    opt = make_optimizer(model.parameters(), cfg.train)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, 3, 32, 32)).astype(
        np.float32))
    for _ in range(steps):
        opt.zero_grad()
        sum(o.float().square().mean() for o in model(x)).backward()
        opt.step()
    return TrainState(model, opt, steps)


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested tree, lists as dicts keyed "0", "1", ...,
    None (orbax's stateless link) and {} as the same empty leaf."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if tree is None or (isinstance(tree, dict) and not tree):
        return {prefix: "empty"}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k, v in w.items():
        if isinstance(v, str):
            assert g[k] == v, k
            continue
        a, b = np.asarray(g[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("train", [{}, {"lr_mode": "poly", "warmup_iters": 1},
                                   {"opt_type": "sgd"}], ids=["amsgrad", "poly", "sgd"])
def test_dcp_tree_equals_jax_orbax_restore(tmp_path, train):
    import jax
    import jax.numpy as jnp

    from pixel_embedded_affinity_tpu.models.resunet2d import ResidualUNet2DDeep as FlaxResUNet
    from pixel_embedded_affinity_tpu.train import checkpoint as jax_ckpt
    from pixel_embedded_affinity_tpu.train.optim import make_optimizer as jax_make_optimizer
    from pixel_embedded_affinity_tpu.train.optim import make_schedule as jax_make_schedule
    from pixel_embedded_affinity_tpu.train.train_step import TrainState as JaxTrainState

    from pixel_embedded_affinity_torch.convert import train_state_from_flax

    cfg = _cfg(**train)
    tc = cfg.train
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: FlaxResUNet(out_channels=2, nfeatures=FILTERS, emd=16).init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32), train=False))
    variables = jax.tree_util.tree_map(
        lambda l: rng.normal(size=l.shape).astype(np.float32), shapes)
    sched = None if tc.lr_mode in ("fixed", "cosine") else jax_make_schedule(
        tc.lr_mode, tc.base_lr, tc.end_lr, tc.total_iters, tc.warmup_iters, tc.decay_iters,
        tc.power)
    tx = jax_make_optimizer(tc.base_lr, eps=0.01, weight_decay=tc.weight_decay or 0.0,
                            opt_type=tc.opt_type, schedule=sched)
    params = variables["params"]
    opt_state = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    _, opt_state = tx.update(grads, opt_state, params)
    state = JaxTrainState(params, variables["batch_stats"], opt_state,
                          jnp.asarray(1, jnp.int32))
    want = jax_ckpt.load_checkpoint_orbax(jax_ckpt.save_checkpoint_orbax(
        str(tmp_path / "jax"), jax.device_get(state), 1))

    model = ResidualUNet2DDeep(3, 2, FILTERS, 16)
    opt = make_optimizer(model.parameters(), tc)
    port = TrainState(model, opt, train_state_from_flax(jax.device_get(state), model, opt))
    target = save_checkpoint_dcp(str(tmp_path / "port"), port, port.step)
    assert os.path.basename(target) == "dcp-000001"
    got = load_checkpoint_dcp(target)
    _assert_same_tree(got, want)
    # the same tree as the port's msgpack file
    _assert_same_tree(got, load_checkpoint(save_checkpoint(str(tmp_path / "mp"), port, 1)))


def _state_tensors(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
             for i, st in enumerate(state.optimizer.state.values())}, state.step,
            state.optimizer.count)


@pytest.mark.parametrize("train", [{}, {"lr_mode": "poly", "warmup_iters": 1}],
                         ids=["amsgrad", "poly"])
def test_resume_from_dcp_equals_resume_from_msgpack(tmp_path, train):
    cfg = _cfg(**train)
    state = _stepped_state(cfg)
    mp = load_checkpoint(save_checkpoint(str(tmp_path), state, state.step))
    dc = load_checkpoint_dcp(save_checkpoint_dcp(str(tmp_path), state, state.step))
    resumed = []
    for ck in (mp, dc):
        fresh = _stepped_state(cfg, seed=9, steps=0)
        restore(fresh, ck)
        resumed.append(fresh)
    a, b = (_state_tensors(s) for s in resumed)
    assert a[2] == b[2] == state.step and a[3] == b[3]
    assert a[0].keys() == b[0].keys()
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert all(torch.equal(a[0][k], v) for k, v in state.model.state_dict().items()
               if not k.endswith("num_batches_tracked"))  # in neither file: not Flax state
    for i in a[1]:
        for k in a[1][i]:
            va, vb = a[1][i][k], b[1][i][k]
            assert torch.equal(va, vb) if torch.is_tensor(va) else va == vb
    # the next step from either resume gives the same bits
    x = torch.ones(2, 3, 32, 32)
    outs = []
    for s in resumed:
        s.optimizer.zero_grad()
        sum(o.float().square().mean() for o in s.model(x)).backward()
        s.optimizer.step()
        outs.append(s.model.state_dict())
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])


def test_dcp_keeps_non_tensor_leaves_as_bytes(tmp_path):
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import BytesStorageMetadata

    state = _stepped_state(_cfg(), steps=1)
    target = save_checkpoint_dcp(str(tmp_path), state, 7)
    meta = FileSystemReader(target).read_metadata().state_dict_metadata
    assert isinstance(meta["step"], BytesStorageMetadata)
    assert isinstance(meta["opt_state/1/count"], BytesStorageMetadata)
    tree = load_checkpoint_dcp(target)
    assert tree["step"].dtype == np.int32 and int(tree["step"]) == 7
    assert tree["opt_state"]["0"] == {} and tree["opt_state"]["2"] == {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_save_and_load_one_tree(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE),
                                                        os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert all(r["equal"] for r in results), results
    target = results[0]["target"]
    # one process reads what the two wrote, and it is the one-process tree
    state = _stepped_state(_cfg())
    _assert_same_tree(load_checkpoint_dcp(target),
                      load_checkpoint(save_checkpoint(str(tmp_path / "one"), state, state.step)))
    # each replicated tensor written once: the two ranks' data files hold
    # what one process writes alone
    def data_bytes(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                   if f.endswith(".distcp"))

    alone = save_checkpoint_dcp(str(tmp_path / "alone"), state, state.step)
    assert 0.9 * data_bytes(alone) <= data_bytes(target) <= 1.1 * data_bytes(alone)


def _rank_main(rank: int, world: int, port: int, out: str):
    """One gloo rank: every rank builds the same state, all save one DCP
    directory, then each loads it and compares with its own tree."""
    import torch.distributed as dist

    from pixel_embedded_affinity_torch.convert import train_state_to_flax

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        state = _stepped_state(_cfg())
        target = save_checkpoint_dcp(out, state, state.step)
        dist.barrier()
        got = load_checkpoint_dcp(target)
        try:
            _assert_same_tree(got, train_state_to_flax(state.model, state.optimizer, state.step))
            equal = True
        except AssertionError:
            equal = False
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"target": target, "equal": equal}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
