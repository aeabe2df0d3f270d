"""What of the JAX package has no counterpart in the port, read with ``ast``
(the JAX package is not imported).

Every public top-level ``def`` or ``class`` of ``pixel_embedded_affinity_tpu/``
must have a counterpart in ``pixel_embedded_affinity_torch/``: a top-level
name of the same spelling in any module of the port, or the port's name
for it in ``COUNTERPARTS``. Otherwise it must stand in one of two explicit
lists: ``STILL_TO_PORT``, each entry with its item of ``ROADMAP.md`` §1,
or ``NEVER`` (by name, or by module in ``NEVER_MODULES``), each with its
reason. An entry for a name that has a counterpart by now, or for a name
the JAX package no longer has, fails too, so the lists stay true."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "pixel_embedded_affinity_tpu")
PORT_PKG = os.path.join(REPO, "pixel_embedded_affinity_torch")

# JAX name -> the port's name for the same function
COUNTERPARTS = {
    # ops/affinity_jax.py is the port's ops/targets.py
    "gen_affs_jax": "gen_affs",
    "weight_binary_ratio_jax": "weight_binary_ratio",
    "weight_binary_ratio_3d_jax": "weight_binary_ratio",
    "label_pyramid_jax": "label_pyramid",
    "label_pyramid_xy_jax": "label_pyramid_xy",
    "seg_to_aff_3d_12ch_jax": "seg_to_aff_3d_12ch",
    "seg_to_aff_3d_unit_jax": "seg_to_aff_3d_unit",
    "build_targets_2d_jax": "build_targets_2d",
    "build_targets_3d_jax": "build_targets_3d",
    # the in-jit un-flips
    "convert_consistency_flip_jax": "convert_consistency_flip",
    "convert_consistency_flip_jax_3d": "convert_consistency_flip_3d",
    "convert_consistency_flip_jax_3d_rule4": "convert_consistency_flip_3d_rule4",
    # the train steps are objects in the port
    "make_train_step_2d": "TrainStep2D",
    "make_train_step_3d": "TrainStep3D",
    # orbax (tensorstore OCDBT) is the JAX package's multi-rank checkpoint;
    # the port's is torch.distributed.checkpoint
    "save_checkpoint_orbax": "save_checkpoint_dcp",
    "load_checkpoint_orbax": "load_checkpoint_dcp",
}

# JAX name -> the item of ROADMAP.md §1 ("Modules still to port") that holds it
STILL_TO_PORT: dict = {}

# the JAX package's space-to-depth twins rewrite a model's layout for the
# TPU's 128-lane padding; on the H100 the 2D twin trained the same function
# 1.76x (float32) and 2.03-2.14x (bf16) slower than the direct model
# (PERF.md §6), and the 3D twin is selected by nothing
_S2D_TWIN = "a TPU lane-padding rewrite of the direct model, which is ported"

NEVER = {
    **{n: _S2D_TWIN for n in ("S2DConv", "ResidualBlockS2D", "ResidualUNet2DDeepS2D",
                              "S2DConv3D", "MergeBNELUS2D", "ResBlockPNIS2D",
                              "UpsampleConvS2D", "UNetPNIEmbeddingDeepS2D")},
    "affinity_2d_small_batch": "a TPU arrangement of fused_affinity_2d, which is ported",
    "convert_resunet2d_deep": "train/convert_torch.py turns reference torch checkpoints into "
                              "Flax trees; the port loads them as they are (convert.py)",
    "convert_unet_pni_deep": "train/convert_torch.py, as convert_resunet2d_deep",
    "convert_unet3d_mala_deep": "train/convert_torch.py, as convert_resunet2d_deep",
    "to_jax_variables": "train/convert_torch.py, as convert_resunet2d_deep",
}

# JAX modules whose unmatched names need no port: Pallas modules whose
# kernels are the port's hand-written ones in csrc/ (PERF.md §6)
NEVER_MODULES = {
    "ops/emb2aff_pallas.py": "K1-K6; csrc/affinity*.cu, ops/emb2aff*_cuda.py",
    "ops/conv3x3_pallas.py": "K7; csrc/conv3x3.cu, ops/conv3x3_cuda.py",
    "ops/conv3x3_blocked.py": "K9a/K9b and the TPU's 128-lane blocked layout "
                              "(pack_weights_blocked, BlockedGeom); csrc/conv3x3.cu reads HWIO "
                              "weights and plain canvases",
    "ops/s2d_block_pallas.py": "K8; csrc/s2d_block.cu, ops/s2d_block_cuda.py",
}


def _public_names(pkg: str) -> dict:
    """{public top-level def/class name: [module paths relative to pkg]}."""
    out: dict = {}
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in tree.body:
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                        and not node.name.startswith("_")):
                    out.setdefault(node.name, []).append(os.path.relpath(path, pkg))
    return out


@pytest.fixture(scope="module")
def names():
    return _public_names(JAX_PKG), _public_names(PORT_PKG)


def _excused(name, modules):
    return name in NEVER or name in STILL_TO_PORT or all(m in NEVER_MODULES for m in modules)


def test_every_jax_name_has_a_counterpart_or_a_list_entry(names):
    jax_names, port_names = names
    missing = sorted(f"{n} ({', '.join(mods)})" for n, mods in jax_names.items()
                     if n not in port_names and n not in COUNTERPARTS and not _excused(n, mods))
    assert not missing, f"no counterpart in the port and in no list: {missing}"


def test_counterparts_exist(names):
    jax_names, port_names = names
    for jax_name, port_name in COUNTERPARTS.items():
        assert jax_name in jax_names, f"{jax_name} is gone from the JAX package"
        assert jax_name not in port_names, f"{jax_name} is in the port under its own name"
        assert port_name in port_names, f"{port_name} (for {jax_name}) is not in the port"


def test_list_entries_are_still_missing(names):
    jax_names, port_names = names
    for name in list(STILL_TO_PORT) + list(NEVER):
        assert name in jax_names, f"{name} is gone from the JAX package: drop its entry"
        assert name not in port_names, f"{name} is ported now: drop its entry"
    for module in NEVER_MODULES:
        with open(os.path.join(JAX_PKG, module)) as f:
            assert "pallas_call" in f.read(), module


def test_still_to_port_items_are_in_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("### 1. Modules still to port"):text.index("### 2.")]
    items = {int(m) for m in re.findall(r"^(\d+)\. \*\*", section, flags=re.M)}
    assert set(STILL_TO_PORT.values()) <= items, (sorted(set(STILL_TO_PORT.values())), items)


def test_the_scan_reads_both_packages_without_importing_jax(names):
    jax_names, port_names = names
    assert "fused_affinity_2d" in jax_names and "fused_affinity_2d" in port_names
    assert len(jax_names) > 250 and len(port_names) > 250


def test_the_port_imports_neither_sklearn_nor_skimage():
    """The card's machine has neither: the port clusters in torch and draws
    its superpixels and boundaries itself."""
    found = []
    for root, _, files in os.walk(PORT_PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                for node in ast.walk(tree):
                    mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                            [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    found += [(path, m) for m in mods if m.split(".")[0] in ("sklearn", "skimage")]
    assert not found, found
