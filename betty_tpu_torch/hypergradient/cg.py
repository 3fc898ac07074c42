"""Conjugate-gradient implicit-differentiation solver
(``betty_tpu/hypergradient/cg.py``).

Keeps the reference's scaling verbatim: the step size's denominator uses
the ``cg_alpha``-scaled HVP while the residual update uses the raw HVP, and
the solution is multiplied by ``cg_alpha`` once more at the end. Then

    out = - (d g / d prev)^T x,   g = d loss_curr / d w.

With ``Config.use_fused_vector_ops`` the recurrence runs on the raveled
parameter vector through the vector kernels (``ops/vector.py``): one
``fused_dot2`` on the first iteration and one ``cg_fused_step`` on every
iteration. The step size stays a device tensor, so a solve on the card
never waits for the host. Bilevel only, like the reference. Under a
data-parallel mesh every HVP and the cross term are averaged over the ranks
(``hvp.py``), so the recurrence runs on global vectors and its scalars are
the same on every rank.
"""

import torch

from betty_tpu_torch.hypergradient.hvp import cross_vjp, make_hvp
from betty_tpu_torch.utils import neg, tree_axpy, tree_dot, tree_scale, tree_zeros_like


def inner_loss(curr, prev, ctx, curr_batch, rng):
    """``loss(w, prev_params)``: curr's training loss on its batch with its
    own and its parent's parameters replaced."""
    from betty_tpu_torch.problems.problem import ctx_replace

    def loss(curr_params, prev_params):
        c = ctx_replace(ctx, curr.name, curr_params)
        c = ctx_replace(c, prev.name, prev_params)
        return curr.eval_loss(c, curr_batch, rng=rng)[0]

    return loss


def cg(vector, curr, prev, ctx, states, curr_batch, rng):
    assert len(curr.paths) == 0, "cg method is not supported for higher-order MLO!"
    config = curr.config
    alpha_s = config.cg_alpha
    loss = inner_loss(curr, prev, ctx, curr_batch, rng)
    w0 = ctx[curr.name]["params"]
    prev0 = ctx[prev.name]["params"]
    hvp_fn = make_hvp(loss, w0, prev0, config.hvp_mode)

    if config.use_fused_vector_ops:
        x = _cg_loop_fused(vector, hvp_fn, config)
    else:
        x = tree_zeros_like(vector)
        r = vector
        p = vector
        for _ in range(config.cg_iterations):
            hvp = hvp_fn(p)
            numerator = tree_dot(r, r)
            denominator = alpha_s * tree_dot(hvp, p)
            ak = numerator / denominator

            x = tree_axpy(ak, p, x)
            r_new = tree_axpy(-ak, hvp, r)
            beta = tree_dot(r_new, r_new) / numerator
            p = tree_axpy(beta, p, r_new)
            r = r_new
    del hvp_fn
    x = tree_scale(x, alpha_s)
    return neg(cross_vjp(loss, w0, prev0, x))


def _cg_loop_fused(vector, hvp_fn, config):
    """The same recurrence on the raveled vector through the B6/B7 kernels."""
    from betty_tpu_torch.ops.vector import cg_fused_step, fused_dot2, tree_ravel, tree_unravel

    alpha_s = config.cg_alpha
    flat_v, _ = tree_ravel(vector)
    x = torch.zeros_like(flat_v)
    r = flat_v
    p = flat_v
    rr = None
    for _ in range(config.cg_iterations):
        hvp, _ = tree_ravel(hvp_fn(tree_unravel(vector, p)))
        if rr is None:
            rr, hp = fused_dot2(r, r, hvp, p)  # one pass for both dots
        else:
            hp = torch.dot(hvp, p)  # rr carried from the previous iteration
        ak = rr / (alpha_s * hp)
        x, r_new, rr_new = cg_fused_step(ak, x, p, r, hvp)
        beta = rr_new / rr
        p = r_new + beta * p
        r, rr = r_new, rr_new
    return tree_unravel(vector, x)
