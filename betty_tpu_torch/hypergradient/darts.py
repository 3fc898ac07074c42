"""DARTS / T1-T2 finite-difference solver (``betty_tpu/hypergradient/darts.py``):

    eps    = darts_alpha / (||v|| + 1e-15)
    grad_p = d/d(prev) loss_curr(w + eps*v)
    grad_n = d/d(prev) loss_curr(w - eps*v)
    out    = (grad_n - grad_p) / (2*eps)

with ``loss_curr`` curr's training loss on its most recent batch. Under a
data-parallel mesh ``v`` is global (so is ``eps``) and ``out`` is averaged
over the ranks.
"""

from betty_tpu_torch.parallel import grad_mean
from betty_tpu_torch.utils import grad, tree_axpy, tree_map, tree_norm


def darts(vector, curr, prev, ctx, states, curr_batch, rng):
    return central_difference(vector, curr.config.darts_alpha, curr, prev, ctx, curr_batch, rng)


def central_difference(vector, R, curr, prev, ctx, curr_batch, rng):
    """``(grad_n - grad_p) / (2 eps)`` at ``w -/+ eps v``, eps = R / ||v||."""
    from betty_tpu_torch.problems.problem import ctx_replace

    eps = R / (tree_norm(vector) + 1e-15)

    def loss_at(curr_params, prev_params):
        c = ctx_replace(ctx, curr.name, curr_params)
        c = ctx_replace(c, prev.name, prev_params)
        loss, _, _ = curr.eval_loss(c, curr_batch, rng=rng)
        return loss

    w = ctx[curr.name]["params"]
    prev_p = ctx[prev.name]["params"]
    grad_fn = grad(loss_at, argnums=1)
    grad_p = grad_fn(tree_axpy(eps, vector, w), prev_p)
    grad_n = grad_fn(tree_axpy(-eps, vector, w), prev_p)
    return grad_mean(tree_map(lambda n, p: (n - p) / (2.0 * eps), grad_n, grad_p))
