"""The trainer's optimizers and learning-rate schedules.

The JAX package's ``train/optim.py`` builds, for ``opt_type="adam"`` (the
reference's ``Adam(lr=1e-4, eps=0.01, weight_decay=1e-6, amsgrad=True)``),
``optax.chain(add_decayed_weights(wd), scale_by_amsgrad(b1, b2, eps),
scale_by_learning_rate(lr))``, the first link only when ``wd`` is
nonzero; for ``opt_type="sgd"`` ``optax.chain(add_decayed_weights(1e-4),
sgd(lr, momentum=0.9))``. ``lr`` is a number or a schedule of the update
index. ``torch.optim.Adam(amsgrad=True)`` is not that update: it keeps the
maximum of the raw second moment and bias-corrects after, while optax
keeps the maximum of the bias-corrected one. The two agree at step 1 and
drift from step 2, so :class:`AMSGrad` writes optax's update out:

    g = grad + wd * p
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    nu_max = max(nu_max, nu / (1 - b2^count))
    p += -lr(n) * (mu / (1 - b1^count)) / (sqrt(nu_max) + eps)

and :class:`SGD` optax's ``trace``:

    g = grad + 1e-4 p;   trace = g + 0.9 trace;   p += -lr(n) * trace

``n`` counts the earlier updates (optax's ``ScaleByScheduleState.count``),
so the first update takes ``schedule(0)``. The bias corrections and the
schedules compute in float32, as optax and jnp compute them. optax's
``eps_root`` is 0 in the JAX package's chain, so it is left out.

The scalars that change from update to update (the rate, and AMSGrad's
bias corrections) are computed on the host in float32 as above, and
:meth:`_Chain.step` writes them into a small device tensor, one a group,
before it runs :meth:`_Chain.update`, which reads them from there. A CUDA
graph of the step (:mod:`.graph_step`) captures ``update`` alone and
refills the tensor before each replay, so no replay uses the rate of the
capture. Multiplying by a 0-d tensor and by a float of the same value
round alike. Dividing does not: on a card the foreach ops divide by a
float through its float32 reciprocal, and by a tensor truly; on the CPU by
either truly. So a divisor's entry holds, on a card, its float32
reciprocal, which the update multiplies by (:func:`_div`), and on the CPU
the divisor itself: the update is the one the floats gave to the bit
(``tests/test_torch_steps_per_call.py`` on the CPU, ``chip_smoke.py``
phase 26 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

_f32 = np.float32


def _recip(d) -> np.float32:
    return _f32(1) / _f32(d)


def _fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32, as XLA's CPU code fuses it."""
    return _f32(np.float64(_f32(a)) * np.float64(_f32(b)) + np.float64(_f32(c)))


def _div(xs, d):
    """``xs`` divided by the divisor that the 0-d tensor ``d`` holds (on a
    card its float32 reciprocal, :meth:`_Chain.load_device_scalars`), to the
    bits of ``torch._foreach_div(xs, float)``: CUDA's foreach division by a
    float multiplies by that reciprocal."""
    if d.is_cuda:
        return torch._foreach_mul(xs, d)
    return torch._foreach_div(xs, d)


def make_schedule(lr_mode: str, base_lr: float, end_lr: float, total_iters: int,
                  warmup_iters: int = 0, decay_iters: int = 100000, power: float = 1.5,
                  step_size: int = 50000, gamma: float = 0.5):
    """``schedule(step) -> lr`` of the JAX package's ``make_schedule``;
    ``None`` for "fixed" and "cosine" (the reference's cosine branch is
    commented out, so its loop runs at ``base_lr``). float32 as XLA
    computes the jitted jnp/optax expressions: a division by a constant is
    a multiplication by its float32 reciprocal, and a multiply-add is one
    fused rounding."""
    if lr_mode in ("fixed", "cosine"):
        return None
    if lr_mode == "poly":  # the reference's calculate_lr, warmup then decay
        span, end = _f32(base_lr - end_lr), _f32(end_lr)

        def sched(step):
            s = _f32(step)
            if s < warmup_iters:
                p = (s * _recip(max(warmup_iters, 1))) ** _f32(power)
                return float(_fma(span, p, end))
            if s < decay_iters:
                frac = _fma(-(s - _f32(warmup_iters)), _recip(decay_iters), 1)
                return float(_fma(span, frac ** _f32(power), end))
            return float(end)
        return sched
    if lr_mode == "steplr":  # optax.exponential_decay(staircase=True)
        return _exponential(base_lr, step_size, gamma, staircase=True)
    if lr_mode == "multi_steplr":  # optax.piecewise_constant_schedule
        def sched(step):
            v, s = _f32(base_lr), _f32(step)
            for threshold in (100000, 150000):
                ind = max(_f32(0), _f32(np.sign(_f32(threshold) - s)))
                v = v * ind + (_f32(1) - ind) * _f32(gamma) * v
            return float(v)
        return sched
    if lr_mode == "explr":
        return _exponential(base_lr, 1, 0.999, staircase=False)
    if lr_mode == "lambdalr":
        def sched(step):
            with np.errstate(invalid="ignore"):  # NaN past total_iters, as in JAX
                return float(_f32(base_lr) * _fma(-_f32(step), _recip(total_iters), 1)
                             ** _f32(0.9))
        return sched
    raise ValueError(f"unknown lr_mode {lr_mode}")


def _exponential(init, transition_steps, rate, staircase):
    def sched(step):
        p = _f32(step) * _recip(transition_steps)
        if staircase:
            p = np.floor(p)
        return float(_f32(init) if step <= 0 else _f32(init) * _f32(rate) ** p)
    return sched


class _Chain(torch.optim.Optimizer):
    """What the two optimizers share: the rate of update ``n`` is
    ``schedule(n)`` (or the group's ``lr``), and ``count`` is ``n``."""

    # the update's scalars that change from update to update, in the order
    # of host_scalars and of each group's device tensor; those it divides by
    # (_div)
    scalar_names: tuple = ("neg_lr",)
    divisors: tuple = ()

    def __init__(self, params, defaults, schedule):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.count = 0
        # one tensor a group for its update's scalars, made at the first
        # step and kept: a CUDA graph of the update reads it where it is
        self.scalar_buffers: list = []

    def __getstate__(self):  # torch's keeps defaults, state and groups alone
        return {**super().__getstate__(), "schedule": self.schedule, "count": self.count,
                "scalar_buffers": self.scalar_buffers}

    def lr(self, group) -> float:
        """The rate the next update takes."""
        if self.schedule is None:
            return group["lr"]
        return float(self.schedule(self.count))

    def host_scalars(self, group) -> dict:
        """The scalars of the group's next update, as floats."""
        return {"neg_lr": -self.lr(group)}

    def load_device_scalars(self):
        """Write the next update's scalars into each group's device tensor,
        on a card a divisor's as its reciprocal in the tensor's dtype
        (:func:`_div`): from pinned memory without waiting, ordered before
        the update on the current stream."""
        if not self.scalar_buffers:
            for group in self.param_groups:
                p = group["params"][0]
                self.scalar_buffers.append(torch.zeros(len(self.scalar_names), dtype=p.dtype,
                                                       device=p.device))
        for group, buf in zip(self.param_groups, self.scalar_buffers):
            recip = (lambda v: 1.0 / v) if buf.dtype == torch.float64 else _recip
            host = self.host_scalars(group)
            vals = [float(recip(host[k])) if buf.is_cuda and k in self.divisors else host[k]
                    for k in self.scalar_names]
            buf.copy_(torch.tensor(vals, dtype=buf.dtype, pin_memory=buf.is_cuda),
                      non_blocking=buf.is_cuda)

    def advance_host_counts(self):
        """Count one update on the host, as :meth:`update` does, for an update
        that a replayed CUDA graph made."""
        self.count += 1

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        self.load_device_scalars()
        self.update()

    @torch.no_grad()
    def update(self):
        """The update of :meth:`step`, its scalars read from the device
        tensors that :meth:`load_device_scalars` filled."""
        for group, buf in zip(self.param_groups, self.scalar_buffers):
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params, dict(zip(self.scalar_names, buf)))
        self.count += 1


class AMSGrad(_Chain):
    """optax's decayed-weights + AMSGrad + learning-rate chain; per-parameter
    state ``count``, ``mu``, ``nu``, ``nu_max`` (optax's
    ``ScaleByAmsgradState`` fields)."""

    scalar_names = ("bc1", "bc2", "neg_lr")
    divisors = ("bc1", "bc2")

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 0.01, weight_decay: float = 1e-6,
                 schedule=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay), schedule)

    def _next_count(self, group) -> int:
        """AMSGrad's count after the group's next update."""
        for p in group["params"]:
            st = self.state.get(p)  # (indexing the defaultdict would add an entry)
            if st:
                return st["count"] + 1
        return 1

    def host_scalars(self, group) -> dict:
        count = self._next_count(group)
        b1, b2 = group["b1"], group["b2"]
        return {"bc1": float(_f32(1) - _f32(b1) ** _f32(count)),
                "bc2": float(_f32(1) - _f32(b2) ** _f32(count)),
                "neg_lr": -self.lr(group)}

    def advance_host_counts(self):
        super().advance_host_counts()
        for st in self.state.values():
            if "count" in st:
                st["count"] += 1

    def _update(self, group, params, scalars):
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
        bc1, bc2 = scalars["bc1"], scalars["bc2"]
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
        torch._foreach_maximum_(nu_max, _div(nu, bc2))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(_div(mu, bc1), denom)
        torch._foreach_add_(params, torch._foreach_mul(upd, scalars["neg_lr"]))
        for st in sts:
            st["count"] = count


class SGD(_Chain):
    """optax's ``add_decayed_weights(1e-4)`` + ``sgd(lr, momentum=0.9)``
    chain; per-parameter state ``trace`` (optax's ``TraceState``)."""

    def __init__(self, params, lr: float = 1e-4, momentum: float = 0.9,
                 weight_decay: float = 1e-4, schedule=None):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay), schedule)

    def _update(self, group, params, scalars):
        for p in params:
            if not self.state[p]:
                self.state[p]["trace"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        trace = [self.state[p]["trace"] for p in params]
        g = [p.grad for p in params]
        if group["weight_decay"]:
            g = torch._foreach_add(g, torch._foreach_mul(params, group["weight_decay"]))
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, g)
        torch._foreach_add_(params, torch._foreach_mul(trace, scalars["neg_lr"]))


def make_optimizer(params, tc, eps: float = 0.01):
    """The optimizer of a TrainConfig, as the JAX loop builds its chain:
    AMSGrad (``eps``, ``weight_decay``) or, with ``opt_type="sgd"``, SGD
    (momentum 0.9, weight decay 1e-4), at the config's schedule."""
    schedule = make_schedule(tc.lr_mode, tc.base_lr, tc.end_lr, tc.total_iters,
                             tc.warmup_iters, tc.decay_iters, tc.power)
    if tc.opt_type == "sgd":
        return SGD(params, lr=tc.base_lr, schedule=schedule)
    if tc.opt_type != "adam":
        raise ValueError(f"unknown opt_type {tc.opt_type!r}")
    return AMSGrad(params, lr=tc.base_lr, eps=eps, weight_decay=tc.weight_decay or 0.0,
                   schedule=schedule)

