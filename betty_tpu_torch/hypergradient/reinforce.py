"""REINFORCE (score-function) hypergradient solver
(``betty_tpu/hypergradient/reinforce.py``).

A zeroth-order estimate of the cross-derivative darts computes, for a
lower-level loss that is not differentiable in the upper problem's
parameters (rounding, sampling, black-box couplings). darts' ``grad_prev``
at ``w -/+ eps v`` is replaced by the antithetic Gaussian score estimate

    1/n sum_i u_i [loss(w', p + sigma u_i) - loss(w', p - sigma u_i)] / (2 sigma),

``u_i ~ N(0, I)``, the gradient of the Gaussian-smoothed loss. The same
directions serve ``w + eps v`` and ``w - eps v`` (common random numbers), so
the outer central difference cancels the noise both sides share:

    eps = reinforce_alpha / (||v|| + 1e-15)
    out = sum_i u_i [d_minus_i - d_plus_i] / (2 sigma 2 eps n).

``reinforce_samples`` pairs run in sequence, 4 n loss evaluations, none
batched (each carries a full forward). No evaluation keeps a graph.

The directions are drawn from one ``torch.Generator`` seeded with
``fold_in(rng, 0x5E1F)`` (``utils.seeded_generator``): for each sample in
turn, one ``randn`` per leaf of the upper problem's parameters, in their
order. So they are not JAX's threefry draws; a compiled block reseeds the
generator before every replay and draws driver mode's directions. A
``directions`` callable ``(rng, i, prev_params) -> tree`` replaces the
draws (tests inject JAX's). Under a data-parallel mesh every rank draws the
same directions (the seed is the step's) and each loss evaluation is
averaged over the ranks.
"""

import torch

from betty_tpu_torch.parallel import grad_mean
from betty_tpu_torch.utils import (fold_in, seeded_generator, tree_axpy, tree_leaves, tree_map,
                                   tree_norm, tree_zeros_like)

SEED_FOLD = 0x5E1F


def reinforce(vector, curr, prev, ctx, states, curr_batch, rng, directions=None):
    from betty_tpu_torch.problems.problem import ctx_replace

    config = curr.config
    n = config.reinforce_samples
    sigma = config.reinforce_sigma
    eps = config.reinforce_alpha / (tree_norm(vector) + 1e-15)

    def loss_at(curr_params, prev_params):
        c = ctx_replace(ctx, curr.name, curr_params)
        c = ctx_replace(c, prev.name, prev_params)
        loss, _, _ = curr.eval_loss(c, curr_batch, rng=rng)
        return grad_mean(loss)

    w = ctx[curr.name]["params"]
    prev_p = ctx[prev.name]["params"]
    if directions is None:
        gen = seeded_generator(fold_in(rng, SEED_FOLD), tree_leaves(prev_p)[0].device)

        def directions(_rng, _i, like):
            return tree_map(lambda x: torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                                  device=x.device), like)

    with torch.no_grad():
        w_plus = tree_axpy(eps, vector, w)
        w_minus = tree_axpy(-eps, vector, w)
        out = tree_zeros_like(prev_p)
        for i in range(n):
            u = directions(rng, i, prev_p)
            p_plus = tree_axpy(sigma, u, prev_p)
            p_minus = tree_axpy(-sigma, u, prev_p)
            d_minus = loss_at(w_minus, p_plus) - loss_at(w_minus, p_minus)
            d_plus = loss_at(w_plus, p_plus) - loss_at(w_plus, p_minus)
            coef = (d_minus - d_plus) / (2.0 * sigma * 2.0 * eps * n)
            out = tree_map(lambda a, ui: a + coef.to(a.dtype) * ui, out, u)
    return out
