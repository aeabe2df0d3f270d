"""The trainer's optimizer: weight decay, then AMSGrad, then -lr.

The JAX package builds ``optax.chain(add_decayed_weights(wd),
scale_by_amsgrad(b1, b2, eps), scale_by_learning_rate(lr))`` for the
reference's ``Adam(lr=1e-4, eps=0.01, weight_decay=1e-6, amsgrad=True)``.
``torch.optim.Adam(amsgrad=True)`` is not that update: it keeps the maximum
of the raw second moment and bias-corrects after, while optax keeps the
maximum of the bias-corrected one. The two agree at step 1 and drift from
step 2, so :class:`AMSGrad` writes optax's update out:

    g = grad + wd * p
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    nu_max = max(nu_max, nu / (1 - b2^count))
    p += -lr * (mu / (1 - b1^count)) / (sqrt(nu_max) + eps)

The bias corrections are computed in float32, as optax computes them.
optax's ``eps_root`` is 0 in the JAX package's chain, so it is left out.
"""

from __future__ import annotations

import numpy as np
import torch


class AMSGrad(torch.optim.Optimizer):
    """optax's decayed-weights + AMSGrad + learning-rate chain; per-parameter
    state ``count``, ``mu``, ``nu``, ``nu_max`` (optax's
    ``ScaleByAmsgradState`` fields)."""

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 0.01, weight_decay: float = 1e-6):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AMSGrad takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    for k in ("mu", "nu", "nu_max"):
                        st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
            sts = [self.state[p] for p in params]
            count = sts[0]["count"] + 1
            if any(st["count"] + 1 != count for st in sts):
                raise RuntimeError("AMSGrad: parameters of one group at different counts")
            b1, b2 = group["b1"], group["b2"]
            mu = [st["mu"] for st in sts]
            nu = [st["nu"] for st in sts]
            nu_max = [st["nu_max"] for st in sts]

            g = [p.grad for p in params]
            if group["weight_decay"]:
                g = torch._foreach_add(g, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
            denom = torch._foreach_sqrt(nu_max)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(params, torch._foreach_mul(upd, -group["lr"]))
            for st in sts:
                st["count"] = count
