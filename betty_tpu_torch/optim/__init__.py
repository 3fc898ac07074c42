"""Functional, differentiable optimizers.

Counterpart of ``betty_tpu/optim/__init__.py``, whose optimizers are optax
chains. Each optimizer here is a pure ``update(grads, opt_state, params,
sched_step) -> (updates, new_opt_state)`` over dicts of tensors that
reproduces its optax chain step for step:

* ``sgd``:  add_decayed_weights -> trace(momentum, nesterov) -> scale(-lr)
* ``adam``: add_decayed_weights (L2 decay folded into the gradient) ->
  scale_by_adam -> scale(-lr)
* ``adamw``: scale_by_adam -> add_decayed_weights (decoupled decay) ->
  scale(-lr)

``scale_by_adam`` keeps raw (not bias-corrected) moments ``mu``/``nu`` and
a step count, bias-corrects with ``1 - beta**count`` computed in float32 as
optax does, and puts ``eps`` outside the square root. ``adam_moments``
returns the raw moments, the layout SAMA's preconditioner reads. Both
``adam`` and ``adamw`` have ``kind="adam"``.

A ``schedule`` gives the learning rate of each step from ``sched_step``.
Per-parameter groups (``grouped()``) are not ported in this slice.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from betty_tpu_torch.utils import tree_map, tree_zeros_like


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` rounded as optax computes it in float32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """A functional optimizer with the metadata betty's solvers read."""

    def __init__(self, kind: str, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, momentum: float = 0.0,
                 nesterov: bool = False, decoupled: bool = False,
                 schedule: Optional[Callable] = None):
        self.kind = kind
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.nesterov = nesterov
        self.decoupled = decoupled
        self.schedule = schedule

    def init(self, params):
        if self.kind == "adam":
            return {"count": 0, "mu": tree_zeros_like(params), "nu": tree_zeros_like(params)}
        if self.momentum:
            return {"trace": tree_zeros_like(params)}
        return {}

    def _lr(self, sched_step):
        if self.schedule is not None and sched_step is not None:
            return self.schedule(sched_step)
        return self.lr

    def update(self, grads, opt_state, params, sched_step=None):
        wd = self.weight_decay
        if self.kind == "adam":
            u = grads
            if wd and not self.decoupled:
                u = tree_map(lambda g, p: g + wd * p, u, params)
            b1, b2 = self.betas
            mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, u, opt_state["mu"])
            nu = tree_map(lambda g, n: (1 - b2) * (g * g) + b2 * n, u, opt_state["nu"])
            count = opt_state["count"] + 1
            bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
            eps = self.eps
            u = tree_map(lambda m, n: (m / bc1) / (torch.sqrt(n / bc2) + eps), mu, nu)
            if wd and self.decoupled:
                u = tree_map(lambda x, p: x + wd * p, u, params)
            new_state = {"count": count, "mu": mu, "nu": nu}
        else:
            u = grads
            if wd:
                u = tree_map(lambda g, p: g + wd * p, u, params)
            new_state = {}
            if self.momentum:
                mom = self.momentum
                trace = tree_map(lambda g, t: g + mom * t, u, opt_state["trace"])
                u = tree_map(lambda g, t: g + mom * t, u, trace) if self.nesterov else trace
                new_state = {"trace": trace}
        lr = self._lr(sched_step)
        updates = tree_map(lambda x: -x * lr, u)
        return updates, new_state

    def adam_moments(self, opt_state):
        """Raw first and second moments ``(mu, nu)`` (SAMA's preconditioner)."""
        if self.kind != "adam":
            raise ValueError("SAMA preconditioning requires an Adam-family optimizer")
        return opt_state["mu"], opt_state["nu"]


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False,
        schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.SGD-equivalent."""
    return Optimizer("sgd", lr, weight_decay=weight_decay, momentum=momentum,
                     nesterov=nesterov, schedule=schedule)


def adam(lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.Adam-equivalent (L2 weight decay folded into the gradient)."""
    return Optimizer("adam", lr, betas=betas, eps=eps, weight_decay=weight_decay,
                     schedule=schedule)


def adamw(lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.AdamW-equivalent (decoupled weight decay)."""
    return Optimizer("adam", lr, betas=betas, eps=eps, weight_decay=weight_decay,
                     decoupled=True, schedule=schedule)
