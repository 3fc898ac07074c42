"""The collectives of the data-parallel strategies, on trees of tensors.

Each rank computes on its local batch; the loss the strategies optimise is
the mean of the ranks' losses, which for equal local batches of a mean
loss is the loss of the global batch. So every place where the JAX package
lets XLA reduce over the sharded batch reduces here over the ranks:

* ``grad_mean``: the mean of a tree of gradients over every rank, one
  ``all_reduce`` a dtype (the leaves flattened into one buffer), outside
  autograd. The direct gradients, the hypergradient vectors, every HVP and
  cross-VJP, darts' central difference and reinforce's loss evaluations go
  through it. With no mesh bound (``mesh.active``) it is the identity.
* ``global_sum`` / ``global_mean`` / ``all_reduce_tree``: the same
  reduction as an autograd op, for reductions inside a graph that is
  differentiated (BatchNorm's statistics, a loss's normaliser, the
  per-step gradients of an ITD replay). Under the mean-of-ranks objective
  the adjoint of a sum over ranks is the sum over ranks of the cotangents,
  so the backward is the same collective; it has a forward-mode rule (the
  same collective on the tangent) and runs inside ``torch.func`` transforms.
* ``rank_share`` / ``global_divisor``: that objective's rule for the terms
  of a program that couple a batch's examples. A rank's loss weighs
  ``1 / world`` in it, so a derivative with respect to a rank's own inputs
  is scaled by ``rank_share()``, and a sum normalised by a batch total
  divides by ``global_divisor`` of the rank's total.
* ``gather_shards``: the whole tensors of FSDP shards, over the ``dp``
  axis, one collective a dtype; differentiable, its backward the
  sum-reduce-scatter of the cotangents (whose backward is the gather).
* ``reduce_scatter_mean``: the gradient of sharded leaves, each rank
  keeping the mean over every rank of its own shard; one
  ``reduce_scatter_tensor`` a dtype over ``dp`` (then an ``all_reduce``
  over ``dcn``).

A world of one is not special-cased: the collectives are made, over one
rank.
"""

from collections import OrderedDict
import warnings

import torch
import torch.distributed as dist

from betty_tpu_torch.parallel import mesh as mesh_mod
from betty_tpu_torch.utils import tree_leaves, tree_map

# newer torch renames these two (``*_single``); the old names work on every
# version the port runs on
warnings.filterwarnings("ignore", category=FutureWarning,
                        message=r".*(all_gather_into_tensor|reduce_scatter_tensor).*deprecated")


def _by_dtype(leaves):
    """Indices of the floating tensor leaves, grouped by (dtype, device)."""
    groups = OrderedDict()
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            groups.setdefault((x.dtype, x.device), []).append(i)
    return groups


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _x: next(it), tree)


def grad_mean(tree, mesh=None):
    """The mean over every rank of each floating leaf of ``tree`` (no
    autograd; other leaves as they are). ``mesh``: default the bound one;
    with none, ``tree`` itself."""
    mesh = mesh if mesh is not None else mesh_mod.current()
    if mesh is None:
        return tree
    leaves = list(tree_leaves(tree))
    out = list(leaves)
    for idx in _by_dtype(leaves).values():
        parts = [leaves[i].detach() for i in idx]
        buf = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(buf, group=mesh.group)
        buf.div_(mesh.world)
        for i, piece in zip(idx, buf.split([p.numel() for p in parts])):
            out[i] = piece.view(leaves[i].shape)
    return _rebuild(tree, out)


def _all_reduce(x, op, mesh):
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=mesh.group)
    if op == "mean":
        y.div_(mesh.world)
    return y


class _AllReduce(torch.autograd.Function):
    """Sum or mean over every rank; backward and forward-mode the same
    collective on the cotangent or tangent."""

    @staticmethod
    def forward(x, op, mesh):
        return _all_reduce(x, op, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op, ctx.mesh = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.op, ctx.mesh), None, None

    @staticmethod
    def jvp(ctx, t, _op, _mesh):
        return _AllReduce.apply(t, ctx.op, ctx.mesh)


def all_reduce_tree(tree, op: str = "mean", mesh=None):
    """``op`` ("mean" or "sum") over every rank of each floating leaf, as
    one differentiable collective a dtype. Identity with no mesh."""
    mesh = mesh if mesh is not None else mesh_mod.current()
    if mesh is None:
        return tree
    leaves = list(tree_leaves(tree))
    out = list(leaves)
    for idx in _by_dtype(leaves).values():
        parts = [leaves[i] for i in idx]
        flat = parts[0].reshape(-1) if len(parts) == 1 else torch.cat(
            [p.reshape(-1) for p in parts])
        red = _AllReduce.apply(flat, op, mesh)
        for i, piece in zip(idx, red.split([p.numel() for p in parts])):
            out[i] = piece.view(leaves[i].shape)
    return _rebuild(tree, out)


def global_sum(x):
    """The sum of ``x`` over the ranks of the bound mesh, differentiable
    (identity with none)."""
    return all_reduce_tree(x, "sum")


def global_mean(x):
    """The mean of ``x`` over the ranks of the bound mesh, differentiable
    (identity with none)."""
    return all_reduce_tree(x, "mean")


def rank_share() -> float:
    """The weight of one rank's loss in the objective, the mean of the
    ranks' losses: ``1 / world`` (1 with no mesh bound). So a rank's
    derivative with respect to its own inputs is ``1 / rank_share()``
    times the global objective's; a term built from such derivatives (an
    input gradient, an input HVP) is multiplied by ``rank_share()``."""
    return 1.0 / mesh_mod.world_size()


def global_divisor(local_total, least=None):
    """The divisor of a rank's sum over its examples that makes the mean of
    the ranks' quotients the global batch's sum over its global total
    (a weight sum, a token count): the ranks' mean of ``local_total``,
    differentiable, with the global total held at ``least`` or more. With
    no mesh: ``max(local_total, least)``."""
    total = global_mean(local_total)
    return total if least is None else torch.clamp(total, min=least * rank_share())


# ---------------------------------------------------------------------------
# FSDP: gathers and reduce-scatters over the dp axis
# ---------------------------------------------------------------------------


def _front(x, d):
    return x if d == 0 else x.movedim(d, 0)


def _gather_flat(shards, dims, mesh):
    """The whole tensors of ``shards`` (each cut along its dim in
    ``dims``), one ``all_gather_into_tensor`` over ``dp`` for them all."""
    n = mesh.dp_size
    parts = [_front(x.detach(), d).contiguous() for x, d in zip(shards, dims)]
    flat = torch.cat([p.reshape(-1) for p in parts])
    buf = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(buf, flat, group=mesh.dp_group)
    rows = buf.view(n, flat.numel()).split([p.numel() for p in parts], dim=1)
    out = []
    for p, d, row in zip(parts, dims, rows):
        whole = row.reshape((n * p.shape[0],) + tuple(p.shape[1:]))
        out.append(whole if d == 0 else whole.movedim(0, d).contiguous())
    return out


def _reduce_scatter_flat(fulls, dims, mesh):
    """This rank's shard of the sum over ``dp`` of each of ``fulls``, one
    ``reduce_scatter_tensor`` for them all."""
    n = mesh.dp_size
    parts = [_front(x.detach(), d).contiguous() for x, d in zip(fulls, dims)]
    # row j of the buffer: rank j's chunk of every leaf, side by side
    rows = [p.reshape(n, -1) for p in parts]
    buf = torch.cat(rows, dim=1).reshape(-1)
    mine = torch.empty(buf.numel() // n, dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(mine, buf, group=mesh.dp_group)
    out = []
    for p, d, piece in zip(parts, dims, mine.split([r.shape[1] for r in rows])):
        s = piece.view((p.shape[0] // n,) + tuple(p.shape[1:]))
        out.append(s if d == 0 else s.movedim(0, d).contiguous())
    return out


def _zeros_for(grads, like):
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, like)]


class _GatherLeaves(torch.autograd.Function):
    """Gather of shards (one dtype); backward the sum-reduce-scatter of the
    cotangents."""

    @staticmethod
    def forward(dims, mesh, *shards):
        return tuple(_gather_flat(shards, dims, mesh))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims, ctx.mesh = inputs[0], inputs[1]
        ctx.like = [x.detach() for x in output]

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_ReduceScatterLeaves.apply(ctx.dims, ctx.mesh,
                                                        *_zeros_for(grads, ctx.like)))


class _ReduceScatterLeaves(torch.autograd.Function):
    """Sum-reduce-scatter of whole tensors (one dtype); backward the gather
    of the cotangents."""

    @staticmethod
    def forward(dims, mesh, *fulls):
        return tuple(_reduce_scatter_flat(fulls, dims, mesh))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims, ctx.mesh = inputs[0], inputs[1]
        ctx.like = [x.detach() for x in output]

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_GatherLeaves.apply(ctx.dims, ctx.mesh,
                                                 *_zeros_for(grads, ctx.like)))


def _flat_by_dtype(tree, dims):
    """``(leaves, dim list, groups)``: the sharded leaves' indices by
    dtype."""
    leaves = list(tree_leaves(tree))
    dlist = list(tree_leaves(dims))
    assert len(dlist) == len(leaves), "shard dims do not match the tree"
    groups = OrderedDict()
    for i, (x, d) in enumerate(zip(leaves, dlist)):
        if d is not None:
            groups.setdefault((x.dtype, x.device), []).append(i)
    return leaves, dlist, groups


def gather_shards(tree, dims, mesh):
    """The whole tensors of the shards of ``tree`` (the leaves whose dim in
    ``dims`` is not None), gathered over ``dp`` in shard order: one
    collective a dtype, differentiable (its backward the sum over ``dp`` of
    the cotangents, reduce-scattered to the shards)."""
    if not dims:
        return tree
    leaves, dlist, groups = _flat_by_dtype(tree, dims)
    out = list(leaves)
    for idx in groups.values():
        whole = _GatherLeaves.apply([dlist[i] for i in idx], mesh, *[leaves[i] for i in idx])
        for i, w in zip(idx, whole):
            out[i] = w
    return _rebuild(tree, out)


def reduce_scatter_mean(tree, dims, mesh):
    """A whole local gradient ``tree`` reduced to its mean over every rank:
    each leaf with a dim in ``dims`` to this rank's shard of it (one
    ``reduce_scatter_tensor`` a dtype over ``dp``, then an ``all_reduce``
    over ``dcn`` if the mesh has one), the other floating leaves whole
    (``grad_mean``). No autograd."""
    leaves, dlist, groups = _flat_by_dtype(tree, dims)
    out = list(leaves)
    for idx in groups.values():
        mine = _reduce_scatter_flat([leaves[i] for i in idx], [dlist[i] for i in idx], mesh)
        for i, m in zip(idx, mine):
            if mesh.dcn_group is not None:
                dist.all_reduce(m, group=mesh.dcn_group)
            out[i] = m.div_(mesh.world)
    rest = [None if d is not None else x for x, d in zip(leaves, dlist)]
    reduced = grad_mean(rest, mesh)
    out = [o if d is not None else r for o, r, d in zip(out, reduced, dlist)]
    return _rebuild(tree, out)


def all_gather_cat(x, group=None):
    """The ranks' ``x`` (same shape) concatenated along dim 0 in rank order
    (no autograd)."""
    n = dist.get_world_size(group)
    x = x.detach().contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out
