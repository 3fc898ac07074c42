"""Functional module abstraction.

Counterpart of ``betty_tpu/module.py``. A problem's parameters are explicit
state owned by the engine, so a module is a pair

    init(rng)                      -> variables  (dict of collections)
    apply(variables, *args, ...)   -> outputs (and possibly mutated collections)

with the trainable parameters under ``variables["params"]``: a flat dict
from parameter name to tensor. :func:`from_torch` wraps an ``nn.Module``
whose ``forward`` takes ``train`` and ``rngs`` keyword arguments; ``apply``
runs it on the given params dict through ``torch.func.functional_call``, so
gradients flow to whatever tensors the caller passes; buffers (BatchNorm's
running statistics) become the mutable ``"batch_stats"`` collection.
:func:`from_fn` wraps a plain ``apply_fn(params, *args)``.

``rngs`` maps a collection name (``"dropout"``) to an integer seed; a module
draws its random numbers from a ``torch.Generator`` seeded with it, so two
calls with the same seed draw the same numbers (the darts and SAMA
re-evaluations rely on it).
"""

from typing import Any, Callable, Dict, Sequence

import torch
from torch import nn


class FunctionalModule:
    """A pure-function module: explicit variables plus an apply function.

    ``apply_fn(variables, *args, train, rngs, mutable) -> out`` or, when
    ``mutable`` is not empty, ``(out, mutated_collections)``.
    """

    def __init__(self, apply_fn: Callable, variables: Dict[str, Any],
                 mutable_collections: Sequence[str] = (),
                 rng_names: Sequence[str] = ("dropout",)):
        self.apply_fn = apply_fn
        self.variables = variables
        self.mutable_collections = tuple(mutable_collections)
        self.rng_names = tuple(rng_names)

    def init(self, rng=None) -> Dict[str, Any]:
        return self.variables

    def apply(self, variables, *args, train: bool = True, rngs=None, mutable=(), **kwargs):
        return self.apply_fn(variables, *args, train=train, rngs=rngs, mutable=mutable,
                             **kwargs)


def from_torch(module: nn.Module, rng_names: Sequence[str] = ("dropout",)) -> FunctionalModule:
    """Wrap an ``nn.Module`` (counterpart of ``betty_tpu.module.from_flax``).

    The initial params dict holds the module's own parameters, detached.
    A module with buffers gets them as a mutable ``"batch_stats"``
    collection (flat dict from buffer name to tensor), and its ``forward``
    takes an ``updates`` keyword: ``apply(..., mutable=("batch_stats",))``
    passes a dict there, into which a train-mode forward puts the new
    value of a buffer under ``(submodule, buffer name)`` instead of writing
    it in place (``models/batchnorm.py``), and returns ``(out,
    {"batch_stats": new})``. Buffers it does not update keep their
    values. Non-persistent buffers are constants the module keeps and are
    not part of the variables."""
    params = {name: p.detach() for name, p in module.named_parameters()}
    # a non-persistent buffer is a constant of the model (IUC's frozen
    # projection), not state: the module keeps it
    persistent = module.state_dict(keep_vars=True)
    buffers = {name: b.detach() for name, b in module.named_buffers() if name in persistent}
    prefixes = {m: f"{name}." if name else "" for name, m in module.named_modules()}

    def apply_fn(variables, *args, train=True, rngs=None, mutable=(), **kwargs):
        kwargs = {**kwargs, "train": train, "rngs": rngs}
        tensors = variables["params"]
        updates = None
        if buffers:
            stats = variables["batch_stats"]
            tensors = {**tensors, **stats}
            updates = kwargs["updates"] = {} if "batch_stats" in mutable else None
        out = torch.func.functional_call(module, tensors, args, kwargs)
        if not mutable:
            return out
        if updates is None:
            return out, {}
        new = dict(stats)
        for (owner, name), value in updates.items():
            new[prefixes[owner] + name] = value
        return out, {"batch_stats": new}

    if not buffers:
        return FunctionalModule(apply_fn, {"params": params}, rng_names=rng_names)
    return FunctionalModule(apply_fn, {"params": params, "batch_stats": buffers},
                            mutable_collections=("batch_stats",), rng_names=rng_names)


def from_fn(apply_fn: Callable, params) -> FunctionalModule:
    """Wrap a plain ``apply_fn(params, *args) -> out`` and a params dict."""

    def wrapped(variables, *args, train=True, rngs=None, mutable=(), **kwargs):
        out = apply_fn(variables["params"], *args, **kwargs)
        return (out, {}) if mutable else out

    return FunctionalModule(wrapped, {"params": params})


def ensure_module(obj) -> FunctionalModule:
    """Accepts a FunctionalModule or an ``(apply_fn, params)`` tuple; wrap an
    ``nn.Module`` with :func:`from_torch`."""
    if isinstance(obj, FunctionalModule):
        return obj
    if isinstance(obj, tuple) and len(obj) == 2 and callable(obj[0]):
        return from_fn(obj[0], obj[1])
    raise TypeError(f"Cannot interpret {type(obj)} as a module; pass a FunctionalModule "
                    "or (apply_fn, params), or use betty_tpu_torch.module.from_torch()")
