"""Weight carry-across between the Flax parameter tree and torch state dicts.

``resunet2d_deep_from_flax`` is the inverse of the JAX package's
``train/convert_torch.py::convert_resunet2d_deep``: Flax conv kernels
(kh, kw, I, O) become (O, I, kh, kw); BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var. ``load_torch_state_dict`` reads a
reference ``.ckpt`` file.
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


def _bn(sd: dict, key: str, p: dict, s: dict):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _residual_block(sd: dict, prefix: str, p: dict, s: dict):
    _conv(sd, f"{prefix}.conv.0", p["conv1"])
    _bn(sd, f"{prefix}.conv.1", p["bn1"], s["bn1"])
    _conv(sd, f"{prefix}.conv.3", p["conv2"])
    _bn(sd, f"{prefix}.conv.4", p["bn2"], s["bn2"])
    _conv(sd, f"{prefix}.project.0", p["project_conv"])
    _bn(sd, f"{prefix}.project.1", p["project_bn"], s["project_bn"])


def resunet2d_deep_from_flax(variables: dict) -> dict:
    """Flax ``{'params', 'batch_stats'}`` of ResidualUNet2DDeep (numpy or
    array leaves) -> state dict of :class:`models.ResidualUNet2DDeep`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _residual_block(sd, "inconv.conv", params["inconv"], stats["inconv"])
    for i in range(1, 5):
        _residual_block(sd, f"down{i}.block", params[f"down{i}"]["block"],
                        stats[f"down{i}"]["block"])
    for i in range(1, 5):
        _residual_block(sd, f"up{i}_emb.block", params[f"up{i}"]["block"],
                        stats[f"up{i}"]["block"])
    for i in range(1, 5):
        _conv(sd, f"outconv{i}.conv", params[f"outconv{i}"])
    _conv(sd, "outconv_emb.conv", params["outconv_emb"])
    seg_p, seg_s = params["binary_seg"], stats["binary_seg"]
    _conv(sd, "binary_seg.0", seg_p["conv1"])
    _bn(sd, "binary_seg.1", seg_p["bn"], seg_s["bn"])
    _conv(sd, "binary_seg.3", seg_p["conv2"])
    return sd


def strip_module_prefix(sd: dict) -> dict:
    """Drop the DataParallel ``module.`` prefix from state-dict keys."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def load_torch_state_dict(path: str) -> dict:
    """Load a reference ``.ckpt`` (``{'model_weights': sd, ...}`` or a bare
    state dict) onto the CPU, ``module.`` prefixes stripped."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("model_weights", ck) if isinstance(ck, dict) else ck
    return strip_module_prefix(sd)
