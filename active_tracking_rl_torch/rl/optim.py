"""SharedAdam and SharedRMSprop with global-norm clipping, and the
train-mode parameter mask.

Port of ``active_tracking_rl_tpu/rl/optim.py:make_optimizer`` and
``rl/learner.py:make_optimizer_for``. The reference's SharedAdam differs
from stock Adam: eps = 1e-3, amsgrad on, denominator sqrt(max v) + eps and
step size lr * sqrt(1 - b2^t) / (1 - b1^t). Its SharedRMSprop: alpha 0.99,
eps 0.1 added outside the square root, no momentum, uncentered. Before each
update the gradients of the optimized parameters are clipped to global norm
`grad_clip` (optax's ``clip_by_global_norm``).

Every parameter an optimizer holds steps on every `step()`, under one step
count per group, as the JAX package's one optax state does. A parameter
without a gradient (one whose player the loss's mode leaves out, so
autograd gave it None) steps with a zero gradient: Adam's moments decay and
its momentum still moves it; RMSprop's square average decays.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
from torch import nn

from active_tracking_rl_torch.config import TrainConfig


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """g <- g if |g| < max_norm else g / |g| * max_norm, in place."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class _ClippedOptimizer(torch.optim.Optimizer):
    """Gradients (zeros where there are none), clipped together, then the
    subclass's `_update(group, params, grads)`."""

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None
        for group in self.param_groups:
            params = group["params"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            clip_by_global_norm_(grads, group["grad_clip"])
            group["step"] += 1
            self._update(group, params, grads)


class SharedAdam(_ClippedOptimizer):
    """The reference SharedAdam (weight decay 0), with gradient clipping."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-3, amsgrad: bool = True,
                 grad_clip: float = 50.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      amsgrad=amsgrad, grad_clip=grad_clip,
                                      step=0))

    def _update(self, group, params, grads) -> None:
        b1, b2 = group["betas"]
        # bias corrections in float32, as the JAX package computes them
        t = torch.tensor(float(group["step"]), dtype=torch.float32)
        step_size = float(group["lr"] * torch.sqrt(1 - b2 ** t)
                          / (1 - b1 ** t))
        for p, g in zip(params, grads):
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                st["max_exp_avg_sq"] = torch.zeros_like(p)
            m = st["exp_avg"].mul_(b1).add_((1 - b1) * g)
            v = st["exp_avg_sq"].mul_(b2).add_((1 - b2) * (g * g))
            vmax = torch.maximum(st["max_exp_avg_sq"], v,
                                 out=st["max_exp_avg_sq"])
            denom = vmax if group["amsgrad"] else v
            p.add_(-step_size * m / (torch.sqrt(denom) + group["eps"]))


class SharedRMSprop(_ClippedOptimizer):
    """The reference SharedRMSprop as the JAX package builds it (alpha 0.99,
    eps 0.1, no momentum, uncentered, weight decay 0), with gradient
    clipping: s <- alpha s + (1 - alpha) g^2, p <- p - lr g / (sqrt(s) + eps).
    """

    def __init__(self, params, lr: float = 7e-4, alpha: float = 0.99,
                 eps: float = 0.1, grad_clip: float = 50.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      grad_clip=grad_clip, step=0))

    def _update(self, group, params, grads) -> None:
        lr, alpha, eps = group["lr"], group["alpha"], group["eps"]
        for p, g in zip(params, grads):
            st = self.state[p]
            if not st:
                st["square_avg"] = torch.zeros_like(p)
            sq = st["square_avg"]
            sq.copy_(alpha * sq + (1 - alpha) * g * g)
            p.add_(-lr * g / (torch.sqrt(sq) + eps))


def trained_parameters(model: nn.Module, train_mode: int) -> List[nn.Parameter]:
    """Mode 0: player0 only; mode 1: player1 only; otherwise all."""
    if train_mode in (0, 1):
        return list(getattr(model, f"player{train_mode}").parameters())
    return list(model.parameters())


def make_optimizer_for(model: nn.Module, tcfg: TrainConfig
                       ) -> _ClippedOptimizer:
    """SharedAdam (`tcfg.optimizer` "Adam") or SharedRMSprop ("RMSprop", at
    its defaults but lr) over the parameters the static train mode trains;
    the others get no update at all (the JAX package zeroes theirs)."""
    params = trained_parameters(model, tcfg.train_mode)
    if tcfg.optimizer == "Adam":
        return SharedAdam(params, lr=tcfg.lr, amsgrad=tcfg.amsgrad,
                          grad_clip=tcfg.grad_clip)
    if tcfg.optimizer == "RMSprop":
        return SharedRMSprop(params, lr=tcfg.lr, grad_clip=tcfg.grad_clip)
    raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
