"""Weight carry-across between the Flax parameter tree and torch state dicts.

``resunet2d_deep_from_flax`` is the inverse of the JAX package's
``train/convert_torch.py::convert_resunet2d_deep``: Flax conv kernels
(kh, kw, I, O) become (O, I, kh, kw); BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var. ``train_state_from_flax`` carries a
JAX train state (parameters, BatchNorm statistics, the AMSGrad moments and
the step) into the port's model and optimizer. ``load_torch_state_dict``
reads a reference ``.ckpt`` file.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p: dict):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
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


def resunet2d_deep_params_from_flax(params: dict) -> dict:
    """A Flax ``params`` tree of ResidualUNet2DDeep -> {torch parameter
    name: tensor}. Any tree of the same structure maps the same way, so
    optax's moment trees (mu, nu, nu_max) do too."""
    sd: dict = {}
    for key, path, kind in _layout():
        (_conv if kind == "conv" else _bn_params)(sd, key, _at(params, path))
    return sd


def resunet2d_deep_from_flax(variables: dict) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of ResidualUNet2DDeep (numpy or
    array leaves) -> state dict of :class:`models.ResidualUNet2DDeep`."""
    sd = resunet2d_deep_params_from_flax(variables["params"])
    for key, path, kind in _layout():
        if kind == "bn":
            _bn_stats(sd, key, _at(variables["batch_stats"], path))
    return sd


def train_state_from_flax(state, model: torch.nn.Module, optimizer) -> int:
    """Load a JAX ``TrainState`` (params, batch_stats, opt_state, step;
    numpy leaves) into the port's model and :class:`train.optim.AMSGrad`;
    returns the step. The optimizer chain must be the JAX
    ``make_optimizer``'s (decayed weights, AMSGrad, lr), whose one stateful
    link is optax's ``ScaleByAmsgradState(count, mu, nu, nu_max)``."""
    model.load_state_dict(resunet2d_deep_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    ams = next(s for s in state.opt_state if hasattr(s, "nu_max"))
    moments = {k: resunet2d_deep_params_from_flax(getattr(ams, k))
               for k in ("mu", "nu", "nu_max")}
    count = int(np.asarray(ams.count))
    dev = next(model.parameters()).device
    per_param = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        per_param[i] = {"count": count,
                        **{k: moments[k][name].to(dev) for k in moments}}
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": per_param, "param_groups": sd["param_groups"]})
    return int(np.asarray(state.step))


def strip_module_prefix(sd: dict) -> dict:
    """Drop the DataParallel ``module.`` prefix from state-dict keys."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> dict:
    """Load a reference ``.ckpt`` (``{'model_weights': sd, ...}`` or a bare
    state dict) onto the CPU, ``module.`` prefixes stripped."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("model_weights", ck) if isinstance(ck, dict) else ck
    return strip_module_prefix(sd)
