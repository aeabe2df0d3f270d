"""Serving artifacts (``pixel_embedded_affinity_torch/infer/export.py``)
against the port's eager serving path and the JAX package's
``infer/export.py`` artifacts of the same weights, on the CPU.

For ``cvppp``, ``bbbc039v1`` (with the mask logits) and ``ac3ac4`` (a
small tile) at narrow widths: ``export_checkpoint`` writes a ``.pt2``,
``load_artifact`` reads it back, and the loaded program serves batches 1
and 3 from one export (the batch is symbolic; the example batch is 2).
Its outputs equal the eager forward with the plain affinity to 1e-6 (the
same ops; measured 0) and JAX's exported StableHLO artifact, run on the
CPU, to 1e-4 (float32 convs summed in other orders). The artifact holds no
kernel launch: its graph is ATen ops only, ``upsample_bilinear2d`` among
them.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

import jax

from pixel_embedded_affinity_tpu.config import load_config as jax_load_config
from pixel_embedded_affinity_tpu.infer import export as jexport
from pixel_embedded_affinity_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pixel_embedded_affinity_tpu.train.loop import build_model as jax_build_model

from pixel_embedded_affinity_torch import inference as cli
from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.convert import (resunet2d_deep_from_flax,
                                                   unet_pni_deep_from_flax)
from pixel_embedded_affinity_torch.infer import (build_model, export_checkpoint,
                                                 forward_affinities, load_artifact,
                                                 make_serving_fn_2d)
from pixel_embedded_affinity_torch.infer.export import input_avals
from pixel_embedded_affinity_torch.ops import affinity_3d_plain, multi_offset

FILTERS = (4, 6, 8, 12, 16)
# preset -> (2D hw or None, 3D tile or None)
PRESETS = {"cvppp": ((64, 48), None), "bbbc039v1": ((48, 64), None),
           "ac3ac4": (None, (4, 32, 32))}
EAGER_ATOL = 1e-6
JAX_ATOL = 1e-4


def _draw(rng):
    def draw(path, leaf):
        if "'var'" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
    return draw


def _setup(name):
    hw, tile = PRESETS[name]
    jcfg = jax_load_config(name)
    jcfg.model.filters = FILTERS
    jcfg.model.dtype = "float32"
    jcfg.model.s2d_train = False
    shape = (1,) + (tuple(tile) + (1,) if tile else tuple(hw) + (3,))
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), np.zeros(shape, np.float32), train=False))
    variables = jax.tree_util.tree_map_with_path(_draw(rng), shapes)
    convert = unet_pni_deep_from_flax if tile else resunet2d_deep_from_flax
    cfg = load_config(name, overrides={"model": {"filters": FILTERS}})
    return jcfg, cfg, variables, convert(variables), shape


@pytest.fixture(scope="module", params=list(PRESETS))
def exported(request, tmp_path_factory):
    name = request.param
    jcfg, cfg, variables, sd, shape = _setup(name)
    hw, tile = PRESETS[name]
    out = tmp_path_factory.mktemp(f"export_{name}")
    kw = dict(hw=hw) if hw else dict(tile=tile)
    ep = export_checkpoint(cfg, sd, str(out / "model.pt2"), device="cpu", **kw)
    jexp = jexport.export_checkpoint(jcfg, variables, str(out / "model.stablehlo"),
                                     platforms=("cpu",), **kw)
    return dict(name=name, cfg=cfg, sd=sd, shape=shape, ep=ep, path=str(out / "model.pt2"),
                jexp=jexport.load_artifact(str(out / "model.stablehlo")), out=out,
                variables=variables, jcfg=jcfg)


def _eager(case, x):
    """The port's eager serving: the dense module, the plain affinity."""
    cfg = case["cfg"]
    model = build_model(cfg, case["sd"], "cpu")
    with torch.no_grad():
        if case["name"] == "ac3ac4":
            emb = model(x.permute(0, 4, 1, 2, 3))[-1]
            return (affinity_3d_plain(emb.float().permute(0, 2, 3, 4, 1)).relu(),)
        offsets = multi_offset(cfg.data.shifts, neighbor=cfg.data.neighbor)
        out = forward_affinities(model, x.permute(0, 3, 1, 2).contiguous(), offsets,
                                 with_mask=bool(cfg.train.mask_weight))
        return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("batch", [1, 3])
def test_artifact_serves_any_batch_like_the_eager_path_and_jax(exported, batch):
    loaded = load_artifact(exported["path"])
    rng = np.random.default_rng(batch)
    x = rng.normal(size=(batch,) + exported["shape"][1:]).astype(np.float32)
    with torch.no_grad():
        got = loaded.module()(torch.from_numpy(x))
    want = _eager(exported, torch.from_numpy(x))
    jgot = exported["jexp"].call(x)
    n_out = 2 if exported["name"] == "bbbc039v1" else 1
    assert len(got) == len(want) == len(jgot) == n_out
    for g, w, j in zip(got, want, jgot):
        assert g.shape == w.shape == j.shape and g.shape[0] == batch
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= EAGER_ATOL
        assert np.abs(g.numpy() - np.asarray(j)).max() <= JAX_ATOL


def test_artifact_holds_aten_ops_and_a_symbolic_batch(exported):
    ep = exported["ep"]
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert all(t.startswith("aten.") for t in targets), targets
    if exported["name"] != "ac3ac4":
        assert "aten.upsample_bilinear2d.vec" in targets
    (aval,) = input_avals(ep)
    assert aval == "float32[b," + ",".join(map(str, exported["shape"][1:])) + "]"
    assert os.path.getsize(exported["path"]) > 0


def test_load_artifact_moves_to_a_device(exported):
    loaded = load_artifact(exported["path"], device="cpu")
    assert all(p.device.type == "cpu" for p in loaded.module().parameters())


def test_make_serving_fn_2d_builds_the_direct_graph():
    cfg = load_config("cvppp", overrides={"model": {"filters": FILTERS, "s2d_train": True}})
    sd = build_model(cfg, None, "cpu").state_dict()
    fn = make_serving_fn_2d(cfg, sd, device="cpu")
    assert type(fn.model).__name__ == "ResidualUNet2DDeep"


def test_cli_export_prints_the_jax_line(tmp_path, capsys):
    """--export writes the artifact and prints JAX's JSON keys."""
    jcfg, cfg, variables, sd, shape = _setup("cvppp")
    fname = jax_save_checkpoint(str(tmp_path / "ck"), {"params": variables["params"],
                                                       "batch_stats": variables["batch_stats"],
                                                       "step": 1}, 1)
    path = str(tmp_path / "cli.pt2")
    cli.main(["-c", "cvppp", "-ck", fname, "--device", "cpu", "--export", path,
              "--export-hw", "32,48", "-o", f"model.filters={FILTERS}"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"artifact": path, "platforms": ["cpu"], "in_avals": ["float32[b,32,48,3]"]}
    with torch.no_grad():
        (affs,) = load_artifact(path).module()(torch.zeros(1, 32, 48, 3))
    assert affs.shape == (1, 10, 32, 48)
