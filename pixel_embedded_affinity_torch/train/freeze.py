"""Parameter freezing (the reference's encoder_dict.py:84; the JAX
package's ``train/freeze.py``): train only a subset of the model.

The JAX package wraps its optax chain in ``optax.multi_transform``, frozen
subtrees taking ``set_to_zero``: they get zero updates, and the inner
chain keeps no state for them. Here the frozen parameters leave the
optimizer's parameter groups (:class:`.optim.AMSGrad` or :class:`.optim.SGD`),
so its step neither moves them nor keeps moments for them. A parameter is
frozen when its top-level module name (the first part of its name in the
state dict, the JAX package's top-level key) starts with one of the
prefixes.
"""

from __future__ import annotations

import torch


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _frozen(name: str, frozen_prefixes) -> bool:
    top = name.split(".", 1)[0]
    return any(top.startswith(f) for f in frozen_prefixes)


def freeze_by_prefix(optimizer: torch.optim.Optimizer, params,
                     frozen_prefixes=("inconv", "down")) -> torch.optim.Optimizer:
    """Take the parameters of ``params`` (a module, or a mapping of names
    to parameters) whose top-level module name starts with any of
    ``frozen_prefixes`` out of ``optimizer``, and any state it holds for
    them; returns ``optimizer``. Call it before the first step."""
    frozen = {id(p) for n, p in _named(params).items() if _frozen(n, frozen_prefixes)}
    for group in optimizer.param_groups:
        group["params"] = [p for p in group["params"] if id(p) not in frozen]
    for p in [p for p in optimizer.state if id(p) in frozen]:
        del optimizer.state[p]
    return optimizer


def trainable_param_count(params, frozen_prefixes=()) -> int:
    """The number of values in the parameters of ``params`` (a module or a
    mapping) outside ``frozen_prefixes``."""
    return sum(p.numel() for n, p in _named(params).items() if not _frozen(n, frozen_prefixes))
