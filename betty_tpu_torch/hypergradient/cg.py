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
the same on every rank. Under tp/ep the vectors are held as shards: the
dots count each shard's partial sum over the model group and each
replicated leaf once (``parallel.sharded_dot``), and the fused loop ravels
the sharded and the replicated leaves into segments, runs B6/B7 on each
and sums a sharded segment's partial dots over the model ranks of its axes
before the step size or ``beta`` is formed.
"""

import torch

from betty_tpu_torch import parallel
from betty_tpu_torch.hypergradient.hvp import cross_vjp, make_hvp
from betty_tpu_torch.utils import neg, tree_axpy, tree_leaves, tree_map, tree_scale, tree_zeros_like


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

    dims = curr.model_dims()

    def tree_dot(a, b):
        return parallel.sharded_dot(a, b, dims)

    if config.use_fused_vector_ops:
        x = _cg_loop_fused(vector, hvp_fn, config, dims)
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


def _cg_loop_fused(vector, hvp_fn, config, dims):
    """The same recurrence on the raveled vector through the B6/B7 kernels.
    On a tp layout the sharded leaves and the replicated ones are raveled
    into segments (one for each set of model axes the leaves are cut over,
    ``collectives.reduction_groups``: two on one model axis, up to four on
    ``mdl x pp`` and on ``mdl x pp x sp``, whose ``sp`` ranks hold the
    same segments), B6/B7 launched on each, and a sharded segment's partial
    dots summed over the model ranks of its axes (one all-reduce for both
    of B6's) before they are used; with no shards there is one segment."""
    from betty_tpu_torch.ops.vector import cg_fused_step, fused_dot2, tree_ravel, tree_unravel

    alpha_s = config.cg_alpha
    mesh = parallel.mesh.model_mesh()
    groups = parallel.collectives.reduction_groups(vector, dims, mesh)
    leaves = tree_leaves(vector)
    seg_of = [None] * len(leaves)
    for k, idx in groups.items():
        for i in idx:
            seg_of[i] = k
    templates = {k: [leaves[i] for i in idx] for k, idx in groups.items()}
    live = list(groups)

    def ravel(tree):
        parts = tree_leaves(tree)
        return {k: tree_ravel([parts[i] for i in idx])[0] for k, idx in groups.items()}

    def unravel(flats):
        parts = {s: iter(tree_unravel(templates[s], flats[s])) for s in live}
        it = iter([next(parts[k]) for k in seg_of])
        return tree_map(lambda _x: next(it), vector)

    def total(partials):
        """The global values of the segments' partial dots (a tuple a
        segment): a sharded segment's summed over the model ranks of its
        axes."""
        out = None
        for s in live:
            v = partials[s]
            if s:
                v = parallel.collectives.reduce_over(torch.stack(v), s, mesh).unbind()
            out = v if out is None else tuple(a + b for a, b in zip(out, v))
        return out

    r = ravel(vector)
    x = {s: torch.zeros_like(r[s]) for s in live}
    p = dict(r)
    rr = None
    for _ in range(config.cg_iterations):
        hvp = ravel(hvp_fn(unravel(p)))
        if rr is None:  # one pass for both dots
            rr, hp = total({s: fused_dot2(r[s], r[s], hvp[s], p[s]) for s in live})
        else:  # rr carried from the previous iteration
            hp, = total({s: (torch.dot(hvp[s], p[s]),) for s in live})
        ak = rr / (alpha_s * hp)
        rr_parts, r_new = {}, {}
        for s in live:
            x[s], r_new[s], rr_parts[s] = cg_fused_step(ak, x[s], p[s], r[s], hvp[s])
        rr_new, = total({s: (rr_parts[s],) for s in live})
        beta = rr_new / rr
        p = {s: r_new[s] + beta * p[s] for s in live}
        r, rr = r_new, rr_new
    return unravel(x)
