"""What of the JAX package has no counterpart in the port, read with ``ast``
(the JAX package is not imported).

Every public top-level ``def`` or ``class`` of ``pixel_embedded_affinity_tpu/``
must have a counterpart in ``pixel_embedded_affinity_torch/``: a top-level
name of the same spelling in any module of the port, or the port's name
for it in ``COUNTERPARTS``. Otherwise it must stand in one of two explicit
lists: ``STILL_TO_PORT``, each entry with its item of ``ROADMAP.md`` §1,
or ``NEVER`` (by name, or by module in ``NEVER_MODULES``), each with its
reason. An entry for a name that has a counterpart by now, or for a name
the JAX package no longer has, fails too, so the lists stay true.

The same holds for parameters. Every parameter of a JAX public function,
or of a public class's ``__init__`` (a Flax module's or a NamedTuple's
fields), whose name has a counterpart must be a parameter of the
counterpart (the union over the port's definitions of that name), or one
of the port's names for it (``PARAM_RENAMES`` for every function,
``PARAM_RENAMES_AT`` for one), or stand in ``PARAMS_TO_PORT`` with its item
of ``ROADMAP.md`` §1 or in ``NEVER_PARAMS`` with its reason; those entries
must stay true as the name lists do."""

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
    "ThroughputMeter": "a host-clock rate with no synchronise, which times the enqueue; the "
                       "port's rates come from the benchmark, and its layers are timed by "
                       "the spans of utils/profiling.py (span)",
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


# JAX parameter -> the port's names for it, in every function that takes it
PARAM_RENAMES = {
    "variables": ("state_dict", "model"),  # a Flax tree -> a state dict or the module
    "key": ("gen",),  # a jax.random key -> a torch.Generator
    "axis": ("dim",),
    "features": ("out_ch",),  # Flax infers the input width, torch takes it as in_ch
    "out_channels": ("out_ch",),
    "tx": ("optimizer",),  # an optax chain -> a torch optimizer
    "raw_u8": ("raw",), "label_i32": ("label",),
    "images_u8": ("images",), "images_f32": ("images",), "labels_i32": ("labels",),
    "embedding_bhwc": ("embedding",), "embedding_bdhwc": ("embedding",),
    "target_bkhw": ("target",), "target_bkdhw": ("target",),
}

# (JAX function, parameter) -> the port's name for it in that function
PARAM_RENAMES_AT = {
    ("blocked_egress", "yflat"): "canvas",
    ("conv3x3_blocked_flat", "xflat"): "canvas",
    ("conv_i8", "w_q"): "w",
    ("ema_intensity_params_3d", "dtype"): "like",  # a tensor of the dtype and device
    ("fused_affinity_wmse_2d", "e_bhwc"): "e",
    **{(f, p): p[0] for f in ("fused_affinity_wmse_2d", "fused_cross_affinity_wmse_2d")
       for p in ("target", "weight", "mask")},
    ("fused_cross_affinity_wmse_2d", "a_bhwc"): "a",
    ("fused_cross_affinity_wmse_2d", "b_bhwc"): "b",
    ("fused_cross_affinity_3d", "a_bdhwc"): "a",
    ("fused_cross_affinity_3d", "b_bdhwc"): "b",
    # the port's TrainState holds the module (its parameters and BatchNorm
    # statistics) and the optimizer (its state)
    ("TrainState", "params"): "model", ("TrainState", "batch_stats"): "model",
    ("TrainState", "opt_state"): "optimizer",
    # the port's fast 3D forward is built from the module, which carries them
    ("build_fast_pni_forward", "filters"): "model", ("build_fast_pni_forward", "emd"): "model",
    # the config's two choices: the fast graph, and the compute dtype, which
    # the module carries
    ("build_tiled_predictor", "cfg"): "fast",
    # the port's make_optimizer reads them from the TrainConfig
    **{("make_optimizer", p): "tc" for p in ("base_lr", "weight_decay", "opt_type",
                                              "schedule")},
}

# (JAX function, parameter) -> the item of ROADMAP.md §1 that holds it
PARAMS_TO_PORT: dict = {}

_TILE_H = "the Pallas kernel's row tile on the TPU; the CUDA kernels choose their own blocks"
_INTERPRET = ("Pallas interpret mode, a TPU kernel run on the CPU; the port's wrappers run "
              "their plain versions on a CPU tensor")
_USE_PALLAS = ("chooses between Pallas kernels and their jnp oracles on one device; the port's "
               "wrappers choose by the tensor's device: the kernels on the card, their plain "
               "versions on the CPU")
_REMAT = ("rematerialises activations to fit a TPU's memory and changes no result; the port "
          "keeps the student's activations (train_step.py)")
_DTYPE = ("a submodule's compute dtype; the port sets it on the whole model "
          "(models/common.py set_compute_dtype)")
_AT_CALL = "the port's step takes the model and the optimizer in the TrainState at each call"

NEVER_PARAMS = {
    **{(f, "tile_h"): _TILE_H for f in (
        "blocked_ingest", "conv3x3_blocked", "conv3x3_blocked_chain", "conv3x3_fused",
        "fused_affinity_2d", "fused_affinity_3d", "fused_affinity_wmse_2d",
        "fused_cross_affinity_2d", "fused_cross_affinity_3d", "fused_cross_affinity_wmse_2d",
        "fused_s2d_block")},
    **{(f, "interpret"): _INTERPRET for f in (
        "conv3x3_blocked", "conv3x3_blocked_chain", "conv3x3_blocked_flat", "conv3x3_fused",
        "fused_affinity_2d", "fused_affinity_3d", "fused_affinity_wmse_2d",
        "fused_cross_affinity_2d", "fused_cross_affinity_3d", "fused_cross_affinity_wmse_2d",
        "fused_s2d_block", "deep_supervision_losses_2d", "ema_embedding_loss_2d",
        "embedding_loss_2d", "embedding_loss_norm5", "make_eval_step_2d",
        "make_train_step_2d", "make_train_step_3d", "train")},
    **{(f, "use_pallas"): _USE_PALLAS for f in (
        "run_inference_2d", "run_cvppp_test", "run_inference_3d", "build_tiled_predictor")},
    **{(f, "one_dispatch"): "the TPU's one-dispatch scan over the image set (NEVER: "
                            "affinity_2d_small_batch and the one-dispatch scan)"
       for f in ("run_inference_2d", "run_cvppp_test")},
    **{(f, "platforms"): "jax.export's lowering platforms; torch.export exports for the "
                         "device of its inputs" for f in ("export_checkpoint", "export_serving")},
    **{(f, p): _REMAT for f, p in (("make_train_step_2d", "remat"),
                                   ("make_train_step_3d", "remat"),
                                   ("UNetPNIEmbeddingDeep", "remat"),
                                   ("UNetPNIEmbeddingDeep", "remat_skip"))},
    **{(f, "dtype"): _DTYPE for f in (
        "Bottleneck", "Down", "LocalAttentionBlock", "MaskHead", "MergeBNELU", "ResBlockPNI",
        "ResidualBlock", "Up", "UpsampleConv")},
    **{(f, p): _AT_CALL for f, p in (("make_train_step_2d", "model"),
                                     ("make_train_step_2d", "tx"),
                                     ("make_train_step_3d", "model"),
                                     ("make_train_step_3d", "tx"),
                                     ("make_eval_step_2d", "model"))},
    ("init_state", "model"): "the port's init_state builds the model from cfg",
    ("init_state", "tx"): "the port's init_state builds the optimizer from cfg",
    ("init_state", "sample_batch"): "Flax initialises a module from a sample's shapes; a torch "
                                    "module is built with its own",
    ("conv_i8", "conv_fn"): "the XLA conv the JAX function wraps; the port's conv_i8 is I8c",
    ("mask_head_loss", "weight_rate"): "the JAX body never reads it (ops/losses.py)",
    ("make_optimizer", "amsgrad"): "no path of either package builds Adam: every training "
                                   "path runs AMSGrad",
    ("run_inference_2d", "save_h5"): "out_dir alone decides: the port writes seg.hdf and "
                                     "affs.hdf (h5py) whenever it is given, and the card's "
                                     "machine, which has no h5py, then raises at the import",
    ("validate_3d", "model"): "the JAX body never reads it: it serves state's weights",
    ("validate_3d", "iters"): "the JAX body never reads it",
    ("TiledInference3D", "device_accumulate"): "removed on purpose: the port serves through "
                                               "run everywhere (ROADMAP.md §3 item 5)",
    ("TiledInference3D", "dense"): "removed on purpose, as device_accumulate",
    **{("upsample_align_corners", p): "every JAX call upsamples H and W by 2; the port's "
                                      "NCHW and NCDHW models call upsample_align_corners and "
                                      "upsample_xy_align_corners for the two forms"
       for p in ("axes", "factors")},
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


def _params_of(node) -> list:
    """The parameters of a def, or of a class's ``__init__`` (its annotated
    fields when it has none: a Flax module, a NamedTuple or a dataclass),
    without self, cls, *args and **kwargs."""
    if isinstance(node, ast.ClassDef):
        init = next((n for n in node.body
                     if isinstance(n, ast.FunctionDef) and n.name == "__init__"), None)
        if init is None:
            return [n.target.id for n in node.body
                    if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]
        node = init
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _public_params(pkg: str) -> dict:
    """{public top-level def/class name: [(module, [parameters])]}."""
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
                    out.setdefault(node.name, []).append((os.path.relpath(path, pkg),
                                                          _params_of(node)))
    return out


@pytest.fixture(scope="module")
def names():
    return _public_names(JAX_PKG), _public_names(PORT_PKG)


@pytest.fixture(scope="module")
def params():
    """(JAX function -> its parameters, the port's counterpart -> the union
    of its definitions' parameters), over the names that have one."""
    jax_params, port_params = _public_params(JAX_PKG), _public_params(PORT_PKG)
    out = {}
    for name, defs in jax_params.items():
        port_name = COUNTERPARTS.get(name, name)
        if port_name in port_params:
            out[name] = ({p for _, ps in defs for p in ps},
                         {p for _, ps in port_params[port_name] for p in ps})
    return out


def _port_names_for(name: str, param: str) -> set:
    return set(PARAM_RENAMES.get(param, ())) | (
        {PARAM_RENAMES_AT[name, param]} if (name, param) in PARAM_RENAMES_AT else set())


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


def test_every_jax_parameter_has_a_counterpart_or_a_list_entry(params):
    missing = sorted(f"{name}({p})" for name, (jax_ps, port_ps) in params.items()
                     for p in jax_ps
                     if p not in port_ps and not (_port_names_for(name, p) & port_ps)
                     and (name, p) not in NEVER_PARAMS and (name, p) not in PARAMS_TO_PORT)
    assert not missing, f"JAX parameters the port's counterpart lacks, in no list: {missing}"


def test_parameter_list_entries_are_still_missing(params):
    for name, p in list(NEVER_PARAMS) + list(PARAMS_TO_PORT):
        assert name in params, f"{name} has no counterpart in the port: drop {name}({p})"
        jax_ps, port_ps = params[name]
        assert p in jax_ps, f"{name} of the JAX package takes no {p}: drop its entry"
        assert p not in port_ps and not (_port_names_for(name, p) & port_ps), (
            f"{name}({p}) is ported now: drop its entry")
    for (name, p), port_name in PARAM_RENAMES_AT.items():
        jax_ps, port_ps = params[name]
        assert p in jax_ps and p not in port_ps and port_name in port_ps, (name, p, port_name)
    used = {p for _, (jax_ps, port_ps) in params.items() for p in jax_ps - port_ps}
    assert set(PARAM_RENAMES) <= used, sorted(set(PARAM_RENAMES) - used)


def test_parameters_to_port_are_in_the_roadmap():
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("### 1. Modules still to port"):text.index("### 2.")]
    items = {int(m) for m in re.findall(r"^(\d+)\. \*\*", section, flags=re.M)}
    assert set(PARAMS_TO_PORT.values()) <= items, (sorted(set(PARAMS_TO_PORT.values())), items)
