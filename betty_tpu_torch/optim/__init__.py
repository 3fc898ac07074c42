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
a step count, bias-corrects with ``1 - beta**count`` computed in the
moments' precision as optax does (float32; float64 for float64 moments),
and puts ``eps`` outside the square root. The bias corrections
and a scheduled learning rate are computed on the host and enter the step
as 0-d device tensors (``utils.step_scalar``): on CUDA a division by a
Python number multiplies by its reciprocal, a division by a tensor
divides as optax does, and a compiled block refreshes them before every
replay of its captured period. ``adam_moments``
returns the raw moments, the layout SAMA's preconditioner reads. Both
``adam`` and ``adamw`` have ``kind="adam"``.

``update_`` is the same step written into the storage of the parameters
and of the moments (``mu``, ``nu``, ``trace``), one leaf at a time: each
leaf goes through the same products and sums in the same operand order
(``m.mul_(b1).add_((1 - b1) * g)`` for ``(1 - b1) * g + b1 * m``: IEEE
addition commutes), so the bits are ``update``'s. It serves the donated
updates (``EngineConfig.donate_state``), where no old state is kept.

A ``schedule`` gives the learning rate of each step from ``sched_step``;
``step_lr``, ``cosine_lr``, ``lambda_lr`` and ``multistep_lr`` build the
JAX package's schedules (torch ``lr_scheduler`` counterparts).

Per-parameter groups (``grouped()``, the ``Problem.param_groups`` hook):
each group re-instantiates the base optimizer's factory with its own
keyword arguments (an optimizer remembers them in ``ctor``, as JAX's
``_ctor``), holds its own state over its own leaves, and draws its own
scheduled learning rate as its own 0-d tensor each step.
"""

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

import functools

from betty_tpu_torch.utils import (step_scalar, tree_leaves, tree_map, tree_paths,
                                   tree_zeros_like, tree_zip)


def _bias_correction(decay: float, count: int, dtype=np.float32) -> float:
    """``1 - decay**count`` rounded as optax computes it: in float32, or in
    float64 for float64 moments (JAX with x64)."""
    return float(dtype(1.0) - dtype(decay) ** dtype(count))


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
        # (factory, keyword arguments) of the factories below: what a
        # parameter group re-instantiates with its overrides
        self.ctor = None

    def init(self, params):
        if self.kind == "adam":
            return {"count": 0, "mu": tree_zeros_like(params), "nu": tree_zeros_like(params)}
        if self.momentum:
            return {"trace": tree_zeros_like(params)}
        return {}

    def lr_at(self, sched_step, like):
        """The learning rate of step ``sched_step``: the constant ``lr``, or
        the schedule's value as a 0-d tensor like ``like``."""
        if self.schedule is not None and sched_step is not None:
            return step_scalar(self.schedule, sched_step, like)
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
            like = tree_leaves(mu)[0]
            dt = np.float64 if like.dtype == torch.float64 else np.float32
            bc1 = step_scalar(functools.partial(_bias_correction, b1, dtype=dt), count, like)
            bc2 = step_scalar(functools.partial(_bias_correction, b2, dtype=dt), count, like)
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
        lr = self.lr_at(sched_step, tree_leaves(u)[0])
        updates = tree_map(lambda x: -x * lr, u)
        return updates, new_state

    def update_(self, grads, opt_state, params, sched_step=None):
        """``update`` applied in place: ``params`` and the moments take the
        step in their own storage, bit for bit ``params + updates`` and the
        new state of ``update``; one leaf's temporaries at a time. The
        per-step scalars are read in ``update``'s order (bias corrections,
        then the learning rate). Returns the new optimizer state: the same
        tensors, with Adam's ``count`` advanced on the host."""
        wd, lr = self.weight_decay, None
        with torch.no_grad():
            if self.kind == "adam":
                b1, b2 = self.betas
                count = opt_state["count"] + 1
                like = tree_leaves(opt_state["mu"])[0]
                dt = np.float64 if like.dtype == torch.float64 else np.float32
                bc1 = step_scalar(functools.partial(_bias_correction, b1, dtype=dt), count, like)
                bc2 = step_scalar(functools.partial(_bias_correction, b2, dtype=dt), count, like)
                for g, p, m, n in tree_zip(grads, params, opt_state["mu"], opt_state["nu"]):
                    if wd and not self.decoupled:
                        g = g + wd * p
                    m.mul_(b1).add_((1 - b1) * g)
                    n.mul_(b2).add_((1 - b2) * (g * g))
                    x = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
                    if wd and self.decoupled:
                        x = x + wd * p
                    lr = self.lr_at(sched_step, x) if lr is None else lr
                    p.add_(-x * lr)
                return {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"]}
            mom = self.momentum
            traces = opt_state["trace"] if mom else tree_map(lambda _: None, params)
            for g, p, t in tree_zip(grads, params, traces):
                if wd:
                    g = g + wd * p
                x = g
                if mom:
                    t.mul_(mom).add_(g)
                    x = g + mom * t if self.nesterov else t
                lr = self.lr_at(sched_step, x) if lr is None else lr
                p.add_(-x * lr)
        return {"trace": opt_state["trace"]} if mom else {}

    def adam_moments(self, opt_state):
        """Raw first and second moments ``(mu, nu)`` (SAMA's preconditioner)."""
        if self.kind != "adam":
            raise ValueError("SAMA preconditioning requires an Adam-family optimizer")
        return opt_state["mu"], opt_state["nu"]


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False,
        schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.SGD-equivalent."""
    opt = Optimizer("sgd", lr, weight_decay=weight_decay, momentum=momentum,
                    nesterov=nesterov, schedule=schedule)
    opt.ctor = (sgd, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                          nesterov=nesterov, schedule=schedule))
    return opt


def adam(lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.Adam-equivalent (L2 weight decay folded into the gradient)."""
    opt = Optimizer("adam", lr, betas=betas, eps=eps, weight_decay=weight_decay,
                    schedule=schedule)
    opt.ctor = (adam, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                           schedule=schedule))
    return opt


def adamw(lr: float, betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, schedule: Optional[Callable] = None) -> Optimizer:
    """torch.optim.AdamW-equivalent (decoupled weight decay)."""
    opt = Optimizer("adam", lr, betas=betas, eps=eps, weight_decay=weight_decay,
                    decoupled=True, schedule=schedule)
    opt.ctor = (adamw, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                            schedule=schedule))
    return opt


# ---- parameter groups (``betty_tpu/optim/__init__.py::grouped``) ----

def _path_str(path) -> str:
    """A leaf's name for a group's ``select``: its keys joined by "/" (the
    port's flat parameter names such as ``layers.0.weight`` are one key)."""
    return "/".join(str(k) for k in path)


def _rebuild(tree, values, prefix=()):
    """``tree``'s structure with each leaf replaced by ``values[path str]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, values, prefix + (i,)) for i, t in enumerate(tree))
    return values[_path_str(prefix)]


class GroupedOptimizer(Optimizer):
    """Per-parameter-group hyperparameters: group ``i`` is the optimizer
    ``groups[i]`` over the leaves labelled ``i`` (``labels``: the params'
    structure with a group index at each leaf). The state is ``{"groups":
    [state of group 0, ...]}``, each over its group's leaves only, keyed by
    their path strings. ``group_meta[i]`` holds the group's ``lr``,
    ``betas``, ``eps`` and ``schedule``."""

    def __init__(self, base: Optimizer, groups, labels, group_meta):
        super().__init__(base.kind, base.lr, betas=base.betas, eps=base.eps,
                         weight_decay=base.weight_decay, momentum=base.momentum,
                         nesterov=base.nesterov, decoupled=base.decoupled,
                         schedule=base.schedule)
        self.groups = groups
        self.labels = labels
        self.group_meta = group_meta
        self._label_of = {_path_str(path): label for path, label in tree_paths(labels)}

    def _split(self, tree):
        """The leaves of ``tree`` by group: one ``{path str: leaf}`` each."""
        out = [{} for _ in self.groups]
        for path, leaf in tree_paths(tree):
            name = _path_str(path)
            out[self._label_of[name]][name] = leaf
        return out

    def init(self, params):
        return {"groups": [opt.init(sub) for opt, sub in zip(self.groups, self._split(params))]}

    def update(self, grads, opt_state, params, sched_step=None):
        updates, states = {}, []
        for opt, g, p, st in zip(self.groups, self._split(grads), self._split(params),
                                 opt_state["groups"]):
            if not p:  # a group no leaf selected
                states.append(st)
                continue
            u, st = opt.update(g, st, p, sched_step=sched_step)
            updates.update(u)
            states.append(st)
        return _rebuild(params, updates), {"groups": states}

    def update_(self, grads, opt_state, params, sched_step=None):
        """``update`` in place: each group steps its own leaves (the
        parameters' own tensors) and moments in their storage."""
        states = []
        for opt, g, p, st in zip(self.groups, self._split(grads), self._split(params),
                                 opt_state["groups"]):
            states.append(opt.update_(g, st, p, sched_step=sched_step) if p else st)
        return {"groups": states}

    def adam_moments(self, opt_state):
        """The groups' raw Adam moments merged into parameter-shaped trees
        (SAMA's preconditioner reads them across groups)."""
        mu, nu = {}, {}
        for i, (opt, st) in enumerate(zip(self.groups, opt_state["groups"])):
            if opt.kind != "adam":
                raise ValueError("SAMA preconditioning with param_groups requires every "
                                 f"group to be Adam-family; group {i} is not.")
            mu.update(st["mu"])
            nu.update(st["nu"])
        return _rebuild(self.labels, mu), _rebuild(self.labels, nu)

    def leaf_hyperparam_trees(self, sched_step, like):
        """Per-leaf ``(lr, beta1, beta2, eps)`` trees for SAMA's
        preconditioning: each group's learning rate at ``sched_step`` (a
        0-d tensor like ``like`` where the group has a schedule) and its
        betas and eps, at each of its leaves."""
        lrs = [opt.lr_at(sched_step, like) for opt in self.groups]

        def of(value):
            return _rebuild(self.labels, {name: value(label)
                                          for name, label in self._label_of.items()})

        return (of(lambda i: lrs[i]), of(lambda i: self.group_meta[i]["betas"][0]),
                of(lambda i: self.group_meta[i]["betas"][1]),
                of(lambda i: self.group_meta[i]["eps"]))


def grouped(base: Optimizer, groups, params) -> GroupedOptimizer:
    """A per-group optimizer from a ``param_groups()`` spec.

    ``groups``: a list of dicts; ``"select"`` is a regex searched in each
    leaf's path string (``None``: every leaf), the other keys override the
    base factory's keyword arguments (``lr``, ``momentum``,
    ``weight_decay``, ...). The first matching group takes a leaf, and a
    leaf no group matches raises ``ValueError``. A base ``schedule``
    applies to every group scaled by ``lr_group / lr_base`` (torch's
    schedulers decay each group proportionally); a group's own
    ``"schedule"`` overrides it."""
    import re

    if base.ctor is None:
        raise ValueError("param_groups requires an optimizer made by a betty_tpu_torch.optim "
                         "factory (sgd/adam/adamw) as the template")
    fn, base_kw = base.ctor
    opts, group_meta = [], []
    for g in groups:
        kw = dict(base_kw)
        kw.update({k: v for k, v in g.items() if k not in ("select", "schedule")})
        sched = g.get("schedule")
        if sched is None and base.schedule is not None:
            g_lr, b_lr, b_sched = kw.get("lr", base.lr), base.lr, base.schedule
            sched = lambda step, _g=g_lr, _b=b_lr, _s=b_sched: _g * _s(step) / _b  # noqa: E731
        if sched is not None:
            kw["schedule"] = sched
        opts.append(fn(**kw))
        group_meta.append({"lr": kw.get("lr", base.lr), "betas": kw.get("betas", base.betas),
                           "eps": kw.get("eps", base.eps), "schedule": sched})

    compiled = [re.compile(g["select"]) if g.get("select") else None for g in groups]

    def label_for(path):
        name = _path_str(path)
        for i, pat in enumerate(compiled):
            if pat is None or pat.search(name):
                return i
        raise ValueError(f"param_groups: no group matches parameter {name!r}; add a "
                         "catch-all group with select=None")

    labels = _rebuild(params, {_path_str(path): label_for(path)
                               for path, _ in tree_paths(params)})
    return GroupedOptimizer(base, opts, labels, group_meta)


# ---- LR schedules (``betty_tpu/optim/__init__.py``): step -> learning rate ----

def step_lr(lr: float, step_size: int, gamma: float = 0.1) -> Callable:
    def schedule(step):
        return lr * gamma ** (step // step_size)

    return schedule


def cosine_lr(lr: float, total_steps: int, min_lr: float = 0.0) -> Callable:
    def schedule(step):
        frac = min(step / max(total_steps, 1), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi * frac))

    return schedule


def lambda_lr(lr: float, lr_lambda: Callable) -> Callable:
    def schedule(step):
        return lr * lr_lambda(step)

    return schedule


def multistep_lr(lr: float, milestones, gamma: float = 0.1) -> Callable:
    """torch ``MultiStepLR``: multiply by ``gamma`` at each milestone step
    (the MWN example's ``--lr_milestones``)."""
    ms = tuple(int(m) for m in milestones)

    def schedule(step):
        return lr * gamma ** sum(step >= m for m in ms)

    return schedule
