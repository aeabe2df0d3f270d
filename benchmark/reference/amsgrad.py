"""AMSGrad as the published training runs it (the reference's
``Adam(lr=1e-4, eps=0.01, weight_decay=1e-6, amsgrad=True)`` in optax's
form, which keeps the maximum of the bias-corrected second moment):

    g = grad + wd p
    mu = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    nu_max = max(nu_max, nu / (1 - b2^t))
    p -= lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

A parameter without a gradient is left as it is.
"""

from __future__ import annotations

import torch


class AMSGrad:
    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 0.01, weight_decay: float = 1e-6):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.t = 0
        self.state = {}

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p in self.params:
            if p.grad is None:
                continue
            g = p.grad + self.wd * p
            if p not in self.state:
                self.state[p] = {k: torch.zeros_like(p) for k in ("mu", "nu", "nu_max")}
            st = self.state[p]
            st["mu"].mul_(self.b1).add_(g, alpha=1 - self.b1)
            st["nu"].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            torch.maximum(st["nu_max"], st["nu"] / bc2, out=st["nu_max"])
            p.sub_(self.lr * (st["mu"] / bc1) / (st["nu_max"].sqrt() + self.eps))
