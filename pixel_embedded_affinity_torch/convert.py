"""Weight carry-across between the Flax parameter tree and torch state dicts.

``resunet2d_deep_from_flax``, ``unet_pni_deep_from_flax`` and
``unet3d_mala_from_flax`` are the inverses of the JAX package's
``train/convert_torch.py::convert_resunet2d_deep``, ``convert_unet_pni_deep``
and ``convert_unet3d_mala_deep``: Flax conv kernels (kh, kw, I, O) or
(kd, kh, kw, I, O) become (O, I, kh, kw) or (O, I, kd, kh, kw); BatchNorm
scale/bias/mean/var become weight/bias/running_mean/running_var; MALA's
depthwise (3, 3, C) kernels become the grouped ConvTranspose3d's
(C, 1, 1, 3, 3). ``resnet_embedding_from_flax`` maps ResNetEmbedding's tree,
whose scopes are the port's module names.
``train_state_from_flax`` carries a JAX train state (parameters, BatchNorm
statistics, the optimizer chain's state and the step) of either model,
held in memory or read from its msgpack file, into the port's model and
optimizer, and ``train_state_to_flax`` carries the port's back, in the
tree the JAX package's checkpoints hold. ``load_torch_state_dict`` reads a reference
``.ckpt`` file.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p: dict):
    k = np.asarray(p["kernel"])
    sd[f"{key}.weight"] = _t(np.transpose(k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn_params(sd: dict, key: str, p: dict):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _bn_stats(sd: dict, key: str, s: dict):
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


_BLOCK = [("conv.0", "conv1", "conv"), ("conv.1", "bn1", "bn"),
          ("conv.3", "conv2", "conv"), ("conv.4", "bn2", "bn"),
          ("project.0", "project_conv", "conv"), ("project.1", "project_bn", "bn")]


def _layout():
    """(torch module key, Flax path, kind) of every conv and BatchNorm."""
    blocks = [("inconv.conv", ("inconv",))]
    blocks += [(f"down{i}.block", (f"down{i}", "block")) for i in range(1, 5)]
    blocks += [(f"up{i}_emb.block", (f"up{i}", "block")) for i in range(1, 5)]
    for key, path in blocks:
        for sub, name, kind in _BLOCK:
            yield f"{key}.{sub}", path + (name,), kind
    for i in range(1, 5):
        yield f"outconv{i}.conv", (f"outconv{i}",), "conv"
    yield "outconv_emb.conv", ("outconv_emb",), "conv"
    yield "binary_seg.0", ("binary_seg", "conv1"), "conv"
    yield "binary_seg.1", ("binary_seg", "bn"), "bn"
    yield "binary_seg.3", ("binary_seg", "conv2"), "conv"


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dconv(sd: dict, key: str, p: dict):
    """MALA's depthwise transpose: kernel (3, 3, C) -> weight (C, 1, 1, 3, 3)."""
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 0, 1))[:, None, None])


_FROM_FLAX = {"conv": _conv, "bn": _bn_params, "dconv": _dconv}


def _params_from_flax(layout, params: dict) -> dict:
    sd: dict = {}
    for key, path, kind in layout:
        _FROM_FLAX[kind](sd, key, _at(params, path))
    return sd


def _with_stats(layout, variables: dict) -> dict:
    sd = _params_from_flax(layout, variables["params"])
    for key, path, kind in layout:
        if kind == "bn":
            _bn_stats(sd, key, _at(variables["batch_stats"], path))
    return sd


def resunet2d_deep_params_from_flax(params: dict) -> dict:
    """A Flax ``params`` tree of ResidualUNet2DDeep -> {torch parameter
    name: tensor}. Any tree of the same structure maps the same way, so
    optax's moment trees (mu, nu, nu_max) do too."""
    return _params_from_flax(list(_layout()), params)


def resunet2d_deep_from_flax(variables: dict) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of ResidualUNet2DDeep (numpy or
    array leaves) -> state dict of :class:`models.ResidualUNet2DDeep`."""
    return _with_stats(list(_layout()), variables)


def resunet2d_from_flax(variables: dict) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of ResidualUNet2D, the single-head
    variant (numpy or array leaves) -> state dict of
    :class:`models.ResidualUNet2D`."""
    layout = [entry for entry in _layout() if not entry[0].startswith("outconv") or
              entry[0].startswith("outconv_emb")]
    return _with_stats(layout, variables)


_PNI_BLOCK = [("block1.0", "conv_in", "conv"), ("block1.1", "bn_in", "bn"),
              ("block2.0", "conv1", "conv"), ("block2.1", "bn1", "bn"),
              ("block2.3", "conv2", "conv"), ("block3", "bn_out", "bn")]


def _pni_layout():
    """(torch module key, Flax path, kind) of every conv and BatchNorm of
    UNetPNIEmbeddingDeep."""
    yield "embed_in.0", ("embed_in",), "conv"
    yield "embed_out.0", ("embed_out",), "conv"
    for name in ("conv0", "conv1", "conv2", "conv3", "center",
                 "conv4", "conv5", "conv6", "conv7"):
        for sub, flax_name, kind in _PNI_BLOCK:
            yield f"{name}.{sub}", (name, flax_name), kind
    for i in range(4):
        yield f"up{i}.1", (f"up{i}", "conv"), "conv"
        yield f"cat{i}.0", (f"cat{i}", "bn"), "bn"
    for name in ("out_put", "out_put1", "out_put2", "out_put3", "out_put4"):
        yield f"{name}.0", (name,), "conv"


def unet_pni_deep_from_flax(variables: dict) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of UNetPNIEmbeddingDeep (numpy or
    array leaves) -> state dict of :class:`models.UNetPNIEmbeddingDeep`."""
    return _with_stats(list(_pni_layout()), variables)


def _module_layout(model: torch.nn.Module):
    """(torch module key, Flax path, kind) of every conv and BatchNorm of a
    model whose module names are its Flax scopes (ResNetEmbedding)."""
    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            yield name, path, "conv"
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            yield name, path, "bn"


def _mala_layout():
    """(torch module key, Flax path, kind) of UNet3DMALADeep's layers."""
    for i in range(1, 19):
        yield f"conv{i}", (f"conv{i}",), "conv"
    for i in range(1, 4):
        yield f"dconv{i}", (f"dconv{i}",), "dconv"


def resnet_embedding_from_flax(variables: dict, depth: int = 50,
                               local_attention: bool = False) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of ResNetEmbedding (numpy or
    array leaves) -> state dict of :class:`models.ResNetEmbedding` of that
    ``depth`` (and ``local_attention``)."""
    from .models import ResNetEmbedding

    with torch.device("meta"):
        model = ResNetEmbedding(depth, local_attention=local_attention)
    return _with_stats(list(_module_layout(model)), variables)


def unet3d_mala_from_flax(variables: dict) -> dict:
    """Flax ``{'params'}`` of UNet3DMALADeep (no BatchNorm) -> state dict
    of :class:`models.UNet3DMALADeep` (the reference's names)."""
    return _params_from_flax(list(_mala_layout()), variables["params"])


def _layout_of(model: torch.nn.Module) -> list:
    from .models import ResidualUNet2DDeep, UNet3DMALADeep, UNetPNIEmbeddingDeep

    if isinstance(model, UNetPNIEmbeddingDeep):
        return list(_pni_layout())
    if isinstance(model, ResidualUNet2DDeep):
        return list(_layout())
    if isinstance(model, UNet3DMALADeep):
        return list(_mala_layout())
    return list(_module_layout(model))


def _put(tree: dict, path, leaf):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def _flax_tree(layout, tensors: dict, stats: bool = False) -> dict:
    """The inverse of :func:`_params_from_flax` (``stats``: of the
    BatchNorm statistics): {torch name: tensor} -> a Flax tree of numpy
    float32 leaves; conv weights (O, I, *k) become kernels (*k, I, O)."""
    tree: dict = {}
    for key, path, kind in layout:
        if stats:
            if kind == "bn":
                _put(tree, path + ("mean",), _np(tensors[f"{key}.running_mean"]))
                _put(tree, path + ("var",), _np(tensors[f"{key}.running_var"]))
        elif kind == "conv":
            w = _np(tensors[f"{key}.weight"])
            _put(tree, path + ("kernel",),
                 np.ascontiguousarray(np.transpose(w, (*range(2, w.ndim), 1, 0))))
            if f"{key}.bias" in tensors:
                _put(tree, path + ("bias",), _np(tensors[f"{key}.bias"]))
        else:
            _put(tree, path + ("scale",), _np(tensors[f"{key}.weight"]))
            _put(tree, path + ("bias",), _np(tensors[f"{key}.bias"]))
    return tree


def _state_dict_tree(x):
    """An optax state held in memory (tuples of named tuples) or restored
    from a file (dicts) -> Flax's ``to_state_dict`` form: named tuples as
    dicts of their fields, tuples as dicts keyed '0', '1', ..., array
    leaves as numpy."""
    if hasattr(x, "_asdict"):
        return {k: _state_dict_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, (tuple, list)):
        return {str(i): _state_dict_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {str(k): _state_dict_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _count(c: int) -> np.ndarray:
    return np.asarray(c, np.int32)


def opt_state_to_flax(model: torch.nn.Module, optimizer) -> dict:
    """The port's optimizer state in the ``to_state_dict`` layout of the
    optax chain the JAX ``make_optimizer`` builds for the same config:
    links '0', '1', ... in chain order, ``{}`` for a stateless link,
    AMSGrad's ``count``/``mu``/``nu``/``nu_max``, SGD's ``trace`` (inside
    ``optax.sgd``'s own chain) and the schedule's ``count``. A parameter
    that never had a gradient holds zero moments, as a fresh state does."""
    from .train.optim import SGD

    layout = _layout_of(model)
    named = list(model.named_parameters())

    def moments(key):
        return _flax_tree(layout, {n: optimizer.state.get(p, {}).get(key, torch.zeros_like(p))
                                   for n, p in named})

    lr_link = {"count": _count(optimizer.count)} if optimizer.schedule is not None else {}
    if isinstance(optimizer, SGD):
        return {"0": {}, "1": {"0": {"trace": moments("trace")}, "1": lr_link}}
    # optax keeps one count; a parameter without a gradient is not stepped
    # here (ROADMAP.md, differences kept), so the stepped ones' count is the
    # chain's
    counts = [optimizer.state[p]["count"] for _, p in named
              if "count" in optimizer.state.get(p, {})]
    ams = {"count": _count(max(counts, default=0)),
           **{k: moments(k) for k in ("mu", "nu", "nu_max")}}
    links = ([{}] if optimizer.param_groups[0]["weight_decay"] else []) + [ams, lr_link]
    return {str(i): link for i, link in enumerate(links)}


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def opt_state_from_flax(opt_state, model: torch.nn.Module, optimizer):
    """Load an optax chain's state (in memory, or a restored dict) into the
    port's optimizer. ValueError when its tree does not have the keys of
    the configured chain's (:func:`opt_state_to_flax`), the case in which
    Flax's ``from_state_dict`` raises in the JAX loop."""
    from .train.optim import SGD

    got = _state_dict_tree(opt_state)
    want = opt_state_to_flax(model, optimizer)
    if _structure(got) != _structure(want):
        raise ValueError("the optimizer state's tree does not match the configured chain's")
    layout = _layout_of(model)
    if isinstance(optimizer, SGD):
        lr_link = got["1"]["1"]
        fields = {"trace": _params_from_flax(layout, got["1"]["0"]["trace"])}
        count = None
    else:
        ams = got["1"] if optimizer.param_groups[0]["weight_decay"] else got["0"]
        lr_link = got[str(len(got) - 1)]
        fields = {k: _params_from_flax(layout, ams[k]) for k in ("mu", "nu", "nu_max")}
        count = int(ams["count"])
    dev = next(model.parameters()).device
    per_param = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        per_param[i] = {k: fields[k][name].to(dev) for k in fields}
        if count is not None:
            per_param[i]["count"] = count
    optimizer.load_state_dict({"state": per_param,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    optimizer.count = int(lr_link["count"]) if lr_link else (count or 0)


def load_flax_variables(model: torch.nn.Module, variables: dict):
    """Load Flax ``{params, batch_stats}`` (numpy or array leaves) into the
    port's model of the same kind."""
    model.load_state_dict(_with_stats(_layout_of(model), variables))


def train_state_from_flax(state, model: torch.nn.Module, optimizer) -> int:
    """Load a JAX ``TrainState`` (params, batch_stats, opt_state, step),
    held in memory or restored from its msgpack file as a dict, of
    ResidualUNet2DDeep or UNetPNIEmbeddingDeep into the port's model of the
    same kind and its optimizer (:mod:`.train.optim`, configured as the
    JAX chain was); returns the step. The optimizer state must have the
    configured chain's tree (:func:`opt_state_from_flax`)."""
    get = state.get if isinstance(state, dict) else lambda k: getattr(state, k)
    load_flax_variables(model, {"params": get("params"), "batch_stats": get("batch_stats")})
    opt_state_from_flax(get("opt_state"), model, optimizer)
    return int(np.asarray(get("step")))


def train_state_to_flax(model: torch.nn.Module, optimizer, step: int) -> dict:
    """The inverse of :func:`train_state_from_flax`: the tree the JAX
    package's ``save_checkpoint`` writes, ``to_state_dict`` of its
    ``TrainState`` (params, batch_stats, opt_state, step) with numpy
    float32 leaves and int32 counts."""
    layout = _layout_of(model)
    sd = model.state_dict()
    return {"params": _flax_tree(layout, sd), "batch_stats": _flax_tree(layout, sd, stats=True),
            "opt_state": opt_state_to_flax(model, optimizer), "step": _count(step)}


def strip_module_prefix(sd: dict) -> dict:
    """Drop the DataParallel ``module.`` prefix from state-dict keys."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> dict:
    """Load a reference ``.ckpt`` (``{'model_weights': sd, ...}`` or a bare
    state dict) onto the CPU, ``module.`` prefixes stripped."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("model_weights", ck) if isinstance(ck, dict) else ck
    return strip_module_prefix(sd)
