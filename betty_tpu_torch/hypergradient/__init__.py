"""Best-response-Jacobian solvers (``betty_tpu/hypergradient/__init__.py``).

Chains matrix-vector products along each backprop path
``[upper, mid_k, ..., mid_1, upper]``: the chain starts with the gradient
of the upper loss with respect to ``path[1]``'s parameters, then applies
one solver per edge ``(curr=path[i], prev=path[i+1])``. Solvers get the
context dict and evaluate losses on perturbed copies; no parameter is
perturbed in place.

Registered: ``darts``, ``sama``, ``cg``, ``neumann`` and ``reinforce``.

Under a data-parallel strategy (a mesh bound by the problem's update) the
starting vector is averaged over the ranks here when the caller did not
(``v_by_child`` already is), and each solver returns a vector averaged over
the ranks (``parallel.grad_mean``), so every rank chains the same global
vectors and a solver's norms and scalars are global.
"""

from betty_tpu_torch.parallel import grad_mean
from betty_tpu_torch.utils import tree_add, grad

from .cg import cg
from .darts import darts
from .neumann import neumann
from .reinforce import reinforce
from .sama import sama

jvp_fn_mapping = {
    "darts": darts,
    "sama": sama,
    "neumann": neumann,
    "cg": cg,
    "reinforce": reinforce,
}


def register_solver(name: str, fn):
    """Extension point: register a custom solver under ``name``."""
    jvp_fn_mapping[name] = fn


def _solver(name):
    assert name in jvp_fn_mapping, f"Unknown hypergradient solver {name!r}"
    return jvp_fn_mapping[name]


def compute_path_grads(problem, ctx, states, batch, path_batches, rng, gas, v_by_child=None):
    """Sum of hypergradient contributions over all of ``problem``'s paths.

    ``v_by_child``: per-child starting vectors already computed by the
    caller's joint backward pass; None = compute them here, in fp32 when
    ``solver_precision`` is "fp32". Returns a gradient tree matching
    ``problem``'s params."""
    from betty_tpu_torch.problems.problem import ctx_replace, force_fp32

    total = None
    for path in problem.paths:
        child = path[1]
        if v_by_child is not None:
            v = v_by_child[child.name]
        else:
            def child_loss(child_params, _child=child):
                c = ctx_replace(ctx, _child.name, child_params)
                loss, _, _ = problem.eval_loss(c, batch, rng=rng)
                return loss / gas

            with force_fp32(problem.config.solver_precision == "fp32"):
                v = grad_mean(grad(child_loss)(ctx[child.name]["params"]))
        v = child.meta_filter_grad(v)

        for i in range(1, len(path) - 1):
            curr, prev = path[i], path[i + 1]
            jvp_fn = _solver(curr.config.type)
            with force_fp32(curr.config.solver_precision == "fp32"):
                v = jvp_fn(v, curr, prev, ctx, states, path_batches[curr.name], rng)
        total = tree_add(total, v)
    return total
