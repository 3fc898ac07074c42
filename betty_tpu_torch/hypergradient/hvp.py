"""Hessian-vector products for the iterative solvers (CG, Neumann).

Counterpart of ``betty_tpu/hypergradient/hvp.py``. ``loss_fn(w, prev)`` is
the inner problem's loss as a function of its own parameters ``w`` and its
parent's ``prev`` (two params dicts). Both modes give ``H p`` with ``H`` the
Hessian of the loss in ``w`` at ``(w0, prev0)``:

* ``"vjp"`` (the reference betty's construction, reverse-over-reverse): the
  gradient ``g`` is taken once with ``create_graph=True``; each ``hvp(p)``
  is ``torch.autograd.grad(g, w, p, retain_graph=True)``.
* ``"jvp"`` (the ``Config`` default, forward-over-reverse):
  ``torch.func.jvp`` of ``torch.func.grad`` of the loss. JAX's
  ``jax.linearize`` shares the primal forward and backward across calls;
  ``torch.func.jvp`` computes them again on every call, so each HVP costs
  one more forward and backward than JAX's.

``cross_vjp`` gives the solvers' cross term ``(dg/dprev)^T x``, reverse
over reverse in both modes, from a gradient graph of its own, as the JAX
solvers take a fresh ``jax.vjp`` for it. ``utils.grad`` detaches its inputs
and cannot be nested, hence this module's own differentiable gradient.

Under a data-parallel mesh both are averaged over the ranks: the HVP of the
global mean loss is the mean of the ranks' HVPs. The mean is taken on the
output of ``torch.func.jvp`` / ``autograd.grad``, outside the transforms.
"""

import torch

from betty_tpu_torch.parallel import grad_mean
from betty_tpu_torch.utils import tree_map


def _grad_graph(loss_fn, w0, prev0, prev_grad):
    """``(w, prev, g)``: leaves that require grad (``prev`` only with
    ``prev_grad``) and ``g = d loss / d w`` with its graph kept. Gradients
    that depend on no input (None, or a constant) are left out of ``g``: they
    add nothing to a product with its Jacobian."""
    w = {k: x.detach().requires_grad_(True) for k, x in w0.items()}
    prev = {k: x.detach().requires_grad_(prev_grad) for k, x in prev0.items()}
    with torch.enable_grad():
        loss = loss_fn(w, prev)
        grads = torch.autograd.grad(loss, list(w.values()), create_graph=True,
                                    allow_unused=True)
    g = {k: gk for k, gk in zip(w, grads) if gk is not None and gk.requires_grad}
    return w, prev, g


def _vjp(g, vector, wrt):
    """``(dg/d wrt)^T vector`` as a params dict shaped like ``wrt``, zero
    where nothing depends on it."""
    keys = list(g)
    inputs = list(wrt.values())
    out = [None] * len(inputs)
    if keys:
        with torch.enable_grad():
            out = torch.autograd.grad([g[k] for k in keys], inputs,
                                      [vector[k].to(g[k].dtype) for k in keys],
                                      retain_graph=True, allow_unused=True)
    return {k: torch.zeros_like(x) if o is None else o.detach()
            for (k, x), o in zip(wrt.items(), out)}


def make_hvp(loss_fn, w0, prev0, mode: str = "jvp"):
    """Return ``hvp(p) -> H @ p`` (``p`` a params dict shaped like ``w0``)
    for the Hessian in ``w`` of ``loss_fn(w, prev0)`` at ``w0``. ``mode``:
    "jvp" (forward-over-reverse, default) or "vjp" (reverse-over-reverse)."""
    if mode == "jvp":
        prev = tree_map(torch.Tensor.detach, prev0)
        primals = tree_map(torch.Tensor.detach, w0)
        grad_fn = torch.func.grad(lambda w: loss_fn(w, prev))

        def hvp(p):
            return grad_mean(torch.func.jvp(grad_fn, (primals,), (p,))[1])

        return hvp
    if mode == "vjp":
        w, _, g = _grad_graph(loss_fn, w0, prev0, prev_grad=False)
        return lambda p: grad_mean(_vjp(g, p, w))
    raise ValueError(f"hvp_mode must be 'jvp' or 'vjp', got {mode!r}")


def cross_vjp(loss_fn, w0, prev0, x):
    """``(d g / d prev)^T x`` with ``g = d loss / d w`` at ``(w0, prev0)``,
    reverse over reverse: the solvers' mixed second-derivative term."""
    _, prev, g = _grad_graph(loss_fn, w0, prev0, prev_grad=True)
    return grad_mean(_vjp(g, x, prev))
