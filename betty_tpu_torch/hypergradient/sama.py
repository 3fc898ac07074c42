"""SAMA solver (``betty_tpu/hypergradient/sama.py``): the incoming vector
is preconditioned by the curvature of curr's Adam update, reconstructed
from the post-step raw moments ``mu``/``nu`` and the cached ``last_grad``,
then a darts-style central difference with ``R = sama_adam_alpha`` gives
the best-response-Jacobian product. Under ``param_groups`` each leaf is
preconditioned with its own group's learning rate, betas and eps. Under
zero/fsdp the moments and ``last_grad`` are gathered whole first; under
tp/ep the preconditioning is elementwise on the shards."""

import torch

from betty_tpu_torch.hypergradient.darts import central_difference
from betty_tpu_torch.utils import tree_leaves, tree_map


def precondition(vector, curr, curr_state):
    """Optimizer-aware preconditioning: sgd = identity, adam below."""
    kind = curr.optimizer.kind if curr.optimizer is not None else "sgd"
    if kind in ("sgd", "custom"):
        return vector
    if kind == "adam":
        return precondition_adam(vector, curr, curr_state)
    raise NotImplementedError(f"SAMA preconditioning for {kind} is not implemented!")


def precondition_adam(vector, curr, curr_state):
    """Reconstruct the pre-step Adam moments from the cached last gradient
    and scale the vector by the local curvature of the Adam update."""
    opt = curr.optimizer
    mu, nu = opt.adam_moments(curr_state["opt_state"])
    last_grad = curr_state.get("last_grad")
    assert last_grad is not None, (
        "SAMA requires last_grad state; is curr's config.type == 'sama'?")
    like = tree_leaves(vector)[0]
    if getattr(opt, "group_meta", None) is not None:
        # param_groups: each leaf takes its own group's lr, betas and eps
        lr_t, b1_t, b2_t, eps_t = opt.leaf_hyperparam_trees(curr_state["sched_step"], like)
    else:
        values = (opt.lr_at(curr_state["sched_step"], like), *opt.betas, opt.eps)
        lr_t, b1_t, b2_t, eps_t = (tree_map(lambda _, v=v: v, mu) for v in values)

    def precond_leaf(v, m, n, lg, lr, b1, b2, eps):
        exp_avg_old = (m - (1 - b1) * lg) / b1 if b1 != 0 else 0.0
        exp_avg_sq_old = (n - (1 - b2) * lg * lg) / b2
        scale = (1 - b1) * b2 * exp_avg_sq_old - b1 * (1 - b2) * lg * exp_avg_old
        scale = scale / (torch.sqrt(n) + eps) ** 3
        return v * scale * lr

    return tree_map(precond_leaf, vector, mu, nu, last_grad, lr_t, b1_t, b2_t, eps_t)


def sama(vector, curr, prev, ctx, states, curr_batch, rng):
    vector = precondition(vector, curr,
                          curr.compute_state(states[curr.name], ("opt_state", "last_grad")))
    return central_difference(vector, curr.config.sama_adam_alpha, curr, prev, ctx,
                              curr_batch, rng)
