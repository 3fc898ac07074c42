"""Neumann-series inverse-Hessian-vector-product solver
(``betty_tpu/hypergradient/neumann.py``):

    g      = d loss_curr / d w                        (curr's own batch)
    p = v;  repeat k times: v <- v - alpha * H v;  p <- p + v
    v2     = alpha * p
    out    = - (d g / d prev)^T v2                    (mixed second derivative)

With ``Config.use_fused_vector_ops`` each iteration's update runs on the
raveled parameter vector as one ``neumann_fused_step`` (``ops/vector.py``).
Bilevel only, like the reference.
"""

from betty_tpu_torch.hypergradient.cg import inner_loss
from betty_tpu_torch.hypergradient.hvp import cross_vjp, make_hvp
from betty_tpu_torch.utils import neg, tree_add, tree_axpy, tree_scale


def neumann(vector, curr, prev, ctx, states, curr_batch, rng):
    assert len(curr.paths) == 0, "neumann method is not supported for higher-order MLO!"
    config = curr.config
    alpha = config.neumann_alpha
    loss = inner_loss(curr, prev, ctx, curr_batch, rng)
    w0 = ctx[curr.name]["params"]
    prev0 = ctx[prev.name]["params"]
    hvp_fn = make_hvp(loss, w0, prev0, config.hvp_mode)

    if config.use_fused_vector_ops:
        from betty_tpu_torch.ops.vector import neumann_fused_step, tree_ravel, tree_unravel

        v_flat, _ = tree_ravel(vector)
        p_flat = v_flat
        for _ in range(config.neumann_iterations):
            hv_flat, _ = tree_ravel(hvp_fn(tree_unravel(vector, v_flat)))
            v_flat, p_flat = neumann_fused_step(alpha, v_flat, hv_flat, p_flat)
        v2 = tree_unravel(vector, alpha * p_flat)
    else:
        v = vector
        p = vector
        for _ in range(config.neumann_iterations):
            hv = hvp_fn(v)
            v = tree_axpy(-alpha, hv, v)
            p = tree_add(p, v)
        v2 = tree_scale(p, alpha)
    del hvp_fn
    return neg(cross_vjp(loss, w0, prev0, v2))
