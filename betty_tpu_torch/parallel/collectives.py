"""The collectives of the strategies, on trees of tensors.

Each rank computes on its local batch; the loss the strategies optimise is
the mean of the batch ranks' losses, which for equal local batches of a
mean loss is the loss of the global batch. So every place where the JAX
package lets XLA reduce over the sharded batch reduces here over the batch
ranks (the mesh's ``batch_group``: every rank of a data-parallel mesh, the
ranks at this rank's model index of one with a model axis):

* ``grad_mean``: the mean of a tree of gradients over the batch ranks, one
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
  ``1 / batch world`` in it, so a derivative with respect to a rank's own
  inputs is scaled by ``rank_share()``, and a sum normalised by a batch
  total divides by ``global_divisor`` of the rank's total.
* ``gather_shards``: the whole tensors of shards, over the ``dp`` axis
  (FSDP) or the model axis (tp/ep), one collective a dtype;
  differentiable. Over ``dp`` its backward is the sum-reduce-scatter of the
  cotangents (the ranks' losses differ); over the model axis the ranks of
  a model group compute one loss and hold the same cotangent of a
  replicated tensor, so the backward is this rank's slice of it.
* ``reduce_scatter_mean``: the gradient of FSDP leaves, each rank keeping
  the mean over every rank of its own shard; one ``reduce_scatter_tensor``
  a dtype over ``dp`` (then an ``all_reduce`` over ``dcn``).

Tensor and expert parallelism (a mesh with a ``mdl`` or ``ep`` axis) add
Megatron's two operators (arXiv:1909.08053) over the model group:
``copy_to_model`` (*f*: identity forward, all-reduce of the cotangent
backward), where a replicated activation enters a computation split over
the model ranks, and ``reduce_from_model`` (*g*: all-reduce forward,
identity backward), where the model ranks' partial results are summed.
Each has a forward-mode rule, so the ``torch.func`` HVPs differentiate
through them. ``sharded_dot`` is the inner product of two parameter trees
in a tp layout: the shards' partial sums reduced over the model group, the
replicated leaves counted once. On two model axes (``dp x mdl x pp``) each
collective runs over one axis's view of the mesh (``Mesh.view``), a leaf
cut on two dims is gathered over each axis in turn, and ``sharded_dot``
reduces each leaf's partial sum over the ranks of the axes it is cut on.

Pipeline and sequence parallelism (a ``pp`` or ``sp`` axis) add three
more over the model group, each with a differentiable backward and a
forward-mode rule:

* ``ring_shift`` (``jax.lax.ppermute`` over the ring ``i -> i + 1``,
  ``betty_tpu/parallel/pipeline.py:114``): one batched ``isend``/``irecv``
  call (``dist.batch_isend_irecv``) for the leaves; backward the reverse
  shift of the cotangents, forward mode the shift of the tangents. Torch
  refuses a send to one's own rank, so over a group of one the shift is an
  ``all_gather_into_tensor`` over that group (a copy; on NCCL a device
  copy), still one collective a call. Gloo sends host memory only: CUDA
  tensors go through the host there.
* ``seq_split`` (the rank's ``L/S`` positions of a replicated activation;
  backward the all-gather of the cotangents) and ``seq_gather`` (the whole
  sequence of every rank's positions, for the keys and values attention
  needs; backward the sum-reduce-scatter of the ranks' partial cotangents,
  forward mode the gather of the tangents). A sequence length the axis
  does not divide raises.

``CALLS`` counts the ring shifts and sequence gathers made (forward,
backward and forward mode alike).

A world of one is not special-cased: the collectives are made, over one
rank.
"""

from collections import Counter, OrderedDict
import warnings

import torch
import torch.distributed as dist

from betty_tpu_torch.parallel import mesh as mesh_mod
from betty_tpu_torch.utils import tree_dot, tree_leaves, tree_map

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


def _batch(mesh):
    """``(group, size)`` of the batch ranks."""
    return mesh.batch_group, mesh.batch_world


def grad_mean(tree, mesh=None):
    """The mean over the batch ranks of each floating leaf of ``tree`` (no
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
        group, size = _batch(mesh)
        dist.all_reduce(buf, group=group)
        buf.div_(size)
        for i, piece in zip(idx, buf.split([p.numel() for p in parts])):
            out[i] = piece.view(leaves[i].shape)
    return _rebuild(tree, out)


def _all_reduce(x, op, mesh):
    y = x.detach().clone().contiguous()
    group, size = _batch(mesh)
    dist.all_reduce(y, group=group)
    if op == "mean":
        y.div_(size)
    return y


class _AllReduce(torch.autograd.Function):
    """Sum or mean over the batch ranks; backward and forward-mode the same
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
    """``op`` ("mean" or "sum") over the batch ranks of each floating leaf,
    as one differentiable collective a dtype. Identity with no mesh."""
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
    """The sum of ``x`` over the batch ranks of the bound mesh,
    differentiable (identity with none)."""
    return all_reduce_tree(x, "sum")


def global_mean(x):
    """The mean of ``x`` over the batch ranks of the bound mesh,
    differentiable (identity with none)."""
    return all_reduce_tree(x, "mean")


def rank_share() -> float:
    """The weight of one rank's loss in the objective, the mean of the
    batch ranks' losses: ``1 / batch world`` (1 with no mesh bound). So a rank's
    derivative with respect to its own inputs is ``1 / rank_share()``
    times the global objective's; a term built from such derivatives (an
    input gradient, an input HVP) is multiplied by ``rank_share()``."""
    return 1.0 / mesh_mod.batch_world()


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
    return _unflatten_gathered(buf, parts, dims, n)


def _unflatten_gathered(buf, parts, dims, n):
    """The whole tensors of ``parts`` (shards moved to the front) from the
    gathered buffer ``buf`` (rank j's concatenated shards in row j)."""
    rows = buf.view(n, -1).split([p.numel() for p in parts], dim=1)
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


def dims_of(tree, dims):
    """The dims of ``tree``'s leaves in ``tree_leaves`` order (matched by
    key, whatever the order of ``dims``'s dicts)."""
    return list(tree_leaves(tree_map(lambda _x, d: d, tree, dims)))


def _flat_by_dtype(tree, dims):
    """``(leaves, dim list, groups)``: the sharded leaves' indices by
    dtype."""
    leaves = list(tree_leaves(tree))
    dlist = dims_of(tree, dims)
    groups = OrderedDict()
    for i, (x, d) in enumerate(zip(leaves, dlist)):
        if d is not None:
            groups.setdefault((x.dtype, x.device), []).append(i)
    return leaves, dlist, groups


def gather_shards(tree, dims, mesh, axis: str = "dp"):
    """The whole tensors of the shards of ``tree`` (the leaves whose dim in
    ``dims`` is not None), gathered in shard order over ``axis``: ``"dp"``
    (FSDP; backward the sum over ``dp`` of the cotangents, reduce-scattered
    to the shards) or ``"model"`` (tp/ep; backward this rank's slice of the
    cotangent). One collective a dtype, differentiable. On two model axes
    a leaf cut on two dims (a ``mesh.Cut``) is gathered over each of its
    axes in turn, one collective a dtype an axis."""
    if not dims:
        return tree
    if axis == "model" and mesh.composed and mesh.view_axis is None:
        return _gather_axes(tree, dims, mesh)
    leaves, dlist, groups = _flat_by_dtype(tree, dims)
    out = list(leaves)
    for idx in groups.values():
        if axis == "model":
            whole = _gather_model([leaves[i] for i in idx], [dlist[i] for i in idx], mesh)
        else:
            whole = _GatherLeaves.apply([dlist[i] for i in idx], mesh, *[leaves[i] for i in idx])
        for i, w in zip(idx, whole):
            out[i] = w
    return _rebuild(tree, out)


def _gather_axes(tree, dims, mesh):
    """``gather_shards`` over the model axes of a composed mesh: for each
    axis, the leaves cut over it gathered over its view (the dims of the
    other axis stay cut until their turn)."""
    for name in mesh.model_axes:
        along = tree_map(lambda _x, d: next((dim for dim, a in mesh_mod.cut_pairs(d, mesh)
                                             if a == name), None), tree, dims)
        if any(d is not None for d in tree_leaves(along)):
            tree = gather_shards(tree, along, mesh.view(name), "model")
    return tree


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
            out[i] = m.div_(mesh.batch_world)
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


# ---------------------------------------------------------------------------
# tp/ep: the model-axis collectives
# ---------------------------------------------------------------------------


def _model_all_reduce(x, mesh):
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=mesh.model_group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity; backward the sum of the cotangents over the
    model group (*g*); forward mode the identity (*f*)."""

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.mesh), None

    @staticmethod
    def jvp(ctx, t, _mesh):
        return _CopyToModel.apply(t, ctx.mesh)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the sum over the model group; backward the identity
    (*f*); forward mode the sum of the tangents (*g*)."""

    @staticmethod
    def forward(x, mesh):
        return _model_all_reduce(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.mesh), None

    @staticmethod
    def jvp(ctx, t, _mesh):
        return _ReduceFromModel.apply(t, ctx.mesh)


def copy_to_model(x, mesh=None):
    """*f* over the model group of ``mesh`` (default the bound one);
    identity without a model axis."""
    mesh = mesh if mesh is not None else mesh_mod.model_mesh()
    return x if mesh is None or not mesh.model_axes else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh=None):
    """*g* over the model group of ``mesh`` (default the bound one);
    identity without a model axis."""
    mesh = mesh if mesh is not None else mesh_mod.model_mesh()
    return x if mesh is None or not mesh.model_axes else _ReduceFromModel.apply(x, mesh)


class _GatherModelFlat(torch.autograd.Function):
    """The model ranks' flat vectors side by side, ``[m, n]``; backward this
    rank's row of the cotangent (after *f*), forward mode the gather of the
    tangents."""

    @staticmethod
    def forward(flat, mesh):
        n = mesh.model_size
        buf = torch.empty((n, flat.numel()), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(buf.view(-1), flat.detach().contiguous(),
                                    group=mesh.model_group)
        return buf

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        # the cotangent is replicated: this rank's row is its shard's, and
        # through f, so that a derivative of the backward (an HVP's, a
        # cross term's) sums the rows' contributions over the model group
        return _CopyToModel.apply(g, ctx.mesh)[ctx.mesh.model_index], None

    @staticmethod
    def jvp(ctx, t, _mesh):
        return _GatherModelFlat.apply(t, ctx.mesh)


def _gather_model(shards, dims, mesh):
    """The whole tensors of ``shards`` (one dtype) over the model group: one
    ``all_gather_into_tensor``, differentiable."""
    parts = [_front(x, d) for x, d in zip(shards, dims)]
    flat = torch.cat([p.reshape(-1) for p in parts])
    buf = _GatherModelFlat.apply(flat, mesh)
    return _unflatten_gathered(buf, parts, dims, mesh.model_size)


def _promote(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def reduction_groups(tree, dims, mesh):
    """``{model axes: [leaf indices]}`` of ``tree`` in ``dims``'s layout:
    the leaves cut over the same axes together, the sharded ones first and
    the replicated ones (``()``) last, so that each group's partial sums
    are reduced over the model ranks of its axes (``mesh.over``) once."""
    groups = OrderedDict()
    for i, d in enumerate(dims_of(tree, dims) if dims else [None] * len(tree_leaves(tree))):
        axes = tuple(a for a in mesh.model_axes
                     if a in {n for _, n in mesh_mod.cut_pairs(d, mesh)}) if mesh else ()
        groups.setdefault(axes, []).append(i)
    return OrderedDict(sorted(groups.items(), key=lambda kv: not kv[0]))


def reduce_over(x, axes, mesh):
    """``x`` summed over the model ranks of ``axes`` (*g*; ``()``: as it
    is)."""
    return _ReduceFromModel.apply(x, mesh.over(axes)) if axes else x


def sharded_dot(a, b, dims=None, mesh=None):
    """``<vec(a), vec(b)>`` of two trees held in a tp layout (``dims``: the
    leaves' shard dims over the model axes, None where replicated): the
    sharded leaves' local dots summed over the model ranks of their axes
    (a leaf cut on ``mdl`` and ``pp`` over the whole model group, one cut
    on ``pp`` alone over the ``pp`` group: the ``mdl`` ranks hold it
    alike), plus the replicated leaves' once; in at least float32,
    differentiable. Without sharded leaves (or a model axis)
    ``utils.tree_dot``."""
    mesh = mesh if mesh is not None else mesh_mod.model_mesh()
    dlist = dims_of(a, dims) if dims else []
    if mesh is None or not any(d is not None for d in dlist):
        return tree_dot(a, b)
    dots = [torch.dot(_promote(x).reshape(-1), _promote(y).reshape(-1))
            for x, y in zip(tree_leaves(a), tree_leaves(b))]
    total = None
    for axes, idx in reduction_groups(a, dims, mesh).items():
        part = reduce_over(torch.stack([dots[i] for i in idx]).sum(), axes, mesh)
        total = part if total is None else total + part
    return total


def sharded_norm(a, dims=None, mesh=None):
    """The global L2 norm of a tree in a tp layout (``sharded_dot``)."""
    return torch.sqrt(sharded_dot(a, a, dims, mesh))


# ---------------------------------------------------------------------------
# pp/sp: the ring shift and the sequence split and gather
# ---------------------------------------------------------------------------

CALLS = Counter()


def _shift(xs, mesh, step):
    """The model ranks' ``xs`` moved ``step`` places around the ring: this
    rank receives the tensors of rank ``i - step`` (mod S). One grouped
    call; over one rank a gather of the group of one."""
    CALLS["ring_shift"] += 1
    group, size = mesh.model_group, mesh.model_size
    xs = [x.detach().contiguous() for x in xs]
    if size == 1:
        out = [torch.empty_like(x) for x in xs]
        for o, x in zip(out, xs):
            dist.all_gather_into_tensor(o, x, group=group)
        return out
    i = mesh.model_index
    members = dist.get_process_group_ranks(group)
    dst, src = members[(i + step) % size], members[(i - step) % size]
    host = dist.get_backend(group) == "gloo" and xs[0].is_cuda
    send = [x.cpu() for x in xs] if host else xs
    recv = [torch.empty_like(x) for x in send]
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in send] + \
        [dist.P2POp(dist.irecv, r, src, group) for r in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(x.device) for r, x in zip(recv, xs)] if host else recv


class _RingShift(torch.autograd.Function):
    """``ppermute`` around the model group's ring by ``step``; backward the
    shift by ``-step`` of the cotangents, forward mode the shift of the
    tangents."""

    @staticmethod
    def forward(mesh, step, *xs):
        return tuple(_shift(xs, mesh, step))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.step = inputs[0], inputs[1]
        ctx.like = [x.detach() for x in output]

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_RingShift.apply(ctx.mesh, -ctx.step,
                                              *_zeros_for(grads, ctx.like)))

    @staticmethod
    def jvp(ctx, _mesh, _step, *tangents):
        return _RingShift.apply(ctx.mesh, ctx.step, *_zeros_for(tangents, ctx.like))


def ring_shift(xs, mesh, step: int = 1):
    """The tensors ``xs`` (a list, the same shapes on every model rank) of
    the rank ``step`` places before this one on the model group's ring
    (``jax.lax.ppermute`` with pairs ``(i, (i + step) % S)``),
    differentiable. Every rank of the group makes the call."""
    return list(_RingShift.apply(mesh, step, *xs))


def _check_seq(n, mesh, dim):
    if n % mesh.model_size:
        raise ValueError(f"sequence parallelism: a sequence of {n} positions (dim {dim}) does "
                         f"not divide over the {mesh.model_size} ranks of the "
                         f"{mesh.model_axis!r} axis")


def _seq_gather(x, mesh, dim):
    """The model ranks' ``x`` concatenated along ``dim`` in rank order."""
    CALLS["seq_gather"] += 1
    front = x.detach().movedim(dim, 0).contiguous()
    n = mesh.model_size
    out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, front, group=mesh.model_group)
    return out.movedim(0, dim)


def _seq_reduce_scatter(x, mesh, dim):
    """This rank's positions along ``dim`` of the model ranks' sum of
    ``x``."""
    CALLS["seq_gather"] += 1
    front = x.detach().movedim(dim, 0).contiguous()
    n = mesh.model_size
    out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, front, group=mesh.model_group)
    return out.movedim(0, dim)


def _seq_part(x, mesh, dim):
    return x.chunk(mesh.model_size, dim)[mesh.model_index]


class _SeqSplit(torch.autograd.Function):
    """This rank's positions of a replicated activation; backward the
    all-gather of the cotangents (``_SeqGatherRep``), forward mode the split
    of the tangents."""

    @staticmethod
    def forward(x, mesh, dim):
        return _seq_part(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _SeqGatherRep.apply(g, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _mesh, _dim):
        return _SeqSplit.apply(t, ctx.mesh, ctx.dim)


class _SeqGatherRep(torch.autograd.Function):
    """The all-gather whose result is used alike on every rank (a split's
    backward): its backward is this rank's part of the replicated
    cotangent."""

    @staticmethod
    def forward(x, mesh, dim):
        return _seq_gather(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _SeqSplit.apply(g, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _mesh, _dim):
        return _SeqGatherRep.apply(t, ctx.mesh, ctx.dim)


class _SeqGather(torch.autograd.Function):
    """The all-gather whose result each rank uses on its own positions
    (attention's keys and values): backward the sum-reduce-scatter of the
    ranks' partial cotangents, forward mode the gather of the tangents."""

    @staticmethod
    def forward(x, mesh, dim):
        return _seq_gather(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _SeqReduceScatter.apply(g, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _mesh, _dim):
        return _SeqGather.apply(t, ctx.mesh, ctx.dim)


class _SeqReduceScatter(torch.autograd.Function):
    """The sum over the model ranks, this rank's positions kept; backward
    the gather of the cotangents (``_SeqGather``)."""

    @staticmethod
    def forward(x, mesh, dim):
        return _seq_reduce_scatter(x, mesh, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _SeqGather.apply(g, ctx.mesh, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _mesh, _dim):
        return _SeqReduceScatter.apply(t, ctx.mesh, ctx.dim)


def seq_split(x, mesh, dim: int = 1):
    """This rank's ``L/S`` positions (a contiguous chunk, chunk ``i`` on
    model rank ``i``) of ``x``, replicated over the model group; backward
    the all-gather of the cotangents."""
    _check_seq(x.shape[dim], mesh, dim)
    return _SeqSplit.apply(x, mesh, dim)


def seq_gather(x, mesh, dim: int = 1):
    """Every model rank's positions of ``x`` along ``dim``, whole, in rank
    order; backward the sum-reduce-scatter of the cotangents."""
    return _SeqGather.apply(x, mesh, dim)
