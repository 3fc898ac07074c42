"""Pipeline parallelism (GPipe) over a ``pp`` mesh axis.

Counterpart of ``betty_tpu/parallel/pipeline.py``. The repeated block stack
of a model is cut into S = ``mesh.shape["pp"]`` stages, one a rank of the
mesh's ``pp`` group (the model group); the batch is cut into M
microbatches that flow through the stages by ring shifts
(``collectives.ring_shift``, JAX's ``ppermute``) in the GPipe fill/drain
schedule (arXiv:1811.06965): M + S - 1 steps, a bubble of (S - 1) / (M + S
- 1).

Stage parameters are STACKED leaves with a leading ``depth`` axis. Each
arrives as this rank's ``depth / S`` blocks (sharded over ``pp``:
``strategy="pp"``, or ``strategy="tp"`` with
``Config.shard_rules=((r"^blocks", ("pp",)),)``) or whole (replicated: then
this rank's blocks are cut from it).

How the gradients come out right. JAX replicates the input batch over
``pp`` and the output with a masked ``psum`` inside ``shard_map``; the
port's ranks each run their own autograd graph, so:

* the activations (and leaves that arrive whole) enter through Megatron's
  *f* over the ``pp`` group (``copy_to_model``: identity forward, sum of
  the cotangents backward). Only stage 0 reads the input (only stage ``s``
  reads its blocks), so their gradients are summed over the stages once;
* the last stage's outputs, zero on every other stage, leave through *g*
  (``reduce_from_model``: all-reduce forward, identity backward), so every
  ``pp`` rank computes the same loss and holds the same cotangent. An
  all-reduce whose backward is an all-reduce too would make every upstream
  gradient S times too large.

Every rank builds the same graph, so every collective is made in the same
order on every rank in the forward, the backward, a double backward and
forward mode. A stage computes its blocks only where it holds a real
microbatch (``0 <= t - s < M``); in a bubble step it runs them on zero rows
of the carry and sends zeros, where JAX computes the bubble on a carry it
then discards: the values are those of JAX's schedule.

With a ``dp`` axis each dp rank pipelines the microbatches of its own rows
(``betty_tpu/parallel/pipeline.py:84-89``, where the batch rides ``dp``).

On a mesh with a second model axis (``dp x mdl x pp``) the pipeline runs
over the ``pp`` view (``Mesh.view``): the ring, *f* and *g* over this
rank's ``pp`` group, while ``block_apply`` may make collectives over the
other axis (the pipelined transformer's Megatron *f*/*g* over ``mdl``). A
stage's ``mdl`` ranks share its step, so they run the same blocks on the
same rows (zero in a bubble) and make the same collectives in one order.
A leaf this rank holds is cut on dim 0 to its stage's blocks, and on its
other dims as the layout puts it (the block takes its heads or columns).
"""

from typing import Callable, Optional

import torch

from betty_tpu_torch.parallel import mesh as mesh_mod
from betty_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model, ring_shift
from betty_tpu_torch.utils import fold_in, tree_leaves, tree_map


def stack_block_params(block_init: Callable, rng, depth: int):
    """``depth`` copies of a block's parameters as one tree of stacked
    leaves with a leading depth axis: ``block_init(seed)`` for each block's
    seed ``fold_in(rng, i)`` (the port draws from seeded generators where
    JAX splits keys; the layout, not the bits, is JAX's)."""
    blocks = [block_init(fold_in(rng, i)) for i in range(depth)]
    return tree_map(lambda *xs: torch.stack(xs), blocks[0], *blocks[1:])


def _depth(stacked_params) -> int:
    return tree_leaves(stacked_params)[0].shape[0]


def _local_blocks(stacked_params, mesh, axis: str, depth: Optional[int]):
    """``(this stage's stacked leaves, whole leaves cut here)``: a leaf with
    ``depth / S`` blocks is this rank's; a whole one (``depth`` blocks, or
    any when ``depth`` is None, as JAX's ``gpipe`` takes them) is cut to
    this rank's blocks after *f*."""
    S = mesh.shape[axis]
    full = _depth(stacked_params) if depth is None else depth
    if full % S != 0:
        raise ValueError(f"depth {full} not divisible by {S} pipeline stages")
    leaves = tree_leaves(stacked_params)
    whole = [S > 1 and x.shape[0] == full for x in leaves]
    for x in leaves:
        if x.shape[0] not in (full, full // S):
            raise ValueError(f"pipeline stage leaf of shape {tuple(x.shape)}: neither the "
                             f"{full} blocks nor the {full // S} of one of {S} stages")
    return leaves, whole


def gpipe(block_apply: Callable, stacked_params, x, mesh=None, axis: str = "pp",
          num_microbatches: Optional[int] = None, depth: Optional[int] = None):
    """Run a stack of blocks as a GPipe pipeline over ``mesh[axis]``.

    ``block_apply(params_i, x) -> x`` applies ONE block (``params_i``: a
    dict of tensors, ``x``: a tuple or list of tensors with a leading batch
    dimension; leaves a block does not change pass through). ``stacked_params``
    leaves carry a leading depth axis, this stage's blocks or all ``depth``
    of them; ``depth % S == 0`` and the (local) batch must divide
    ``num_microbatches`` (default S). ``mesh``: the port's ``Mesh`` (default
    the bound one). Returns the carry after all blocks, replicated over
    ``axis``."""
    mesh = mesh if mesh is not None else mesh_mod.current()
    if mesh is not None and axis in mesh.model_axes:
        mesh = mesh.view(axis)  # on several model axes: the ring over this axis
    if mesh is None or axis not in mesh.shape or mesh.model_axis != axis:
        raise ValueError(f"gpipe: needs a mesh whose model axis is {axis!r} (got "
                         f"{None if mesh is None else mesh.axes})")
    S = mesh.shape[axis]
    xs = list(x)
    if not all(a.is_floating_point() for a in xs):
        raise ValueError("gpipe: the carry's leaves must be floating tensors (pass a mask as "
                         "0/1 floats)")
    B = xs[0].shape[0]
    M = num_microbatches or S
    leaves, whole = _local_blocks(stacked_params, mesh, axis, depth)
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    idx = mesh.model_index

    # the input and the leaves that arrive whole enter through one f
    entering = xs + [w for w, wh in zip(leaves, whole) if wh]
    flat = copy_to_model(torch.cat([a.reshape(-1) for a in entering]), mesh)
    pieces = iter(flat.split([a.numel() for a in entering]))
    xs = [next(pieces).view(a.shape) for a in xs]
    local = [next(pieces).view(w.shape).chunk(S)[idx] if wh else w
             for w, wh in zip(leaves, whole)]
    it = iter(local)
    params_local = tree_map(lambda _l: next(it), stacked_params)
    n_local = local[0].shape[0]

    def apply_local(h):
        for j in range(n_local):
            h = list(block_apply(tree_map(lambda a: a[j], params_local), h))
        return h

    x_mb = [a.reshape((M, mb) + tuple(a.shape[1:])) for a in xs]
    # fills on the device, not copies from the host (a CUDA graph captures them)
    dev = xs[0].device
    first_stage = torch.full((), idx == 0, dtype=torch.bool, device=dev)
    last_stage = torch.full((), idx == S - 1, dtype=torch.bool, device=dev)
    carry = [torch.zeros_like(a[0]) for a in x_mb]
    outs = []
    for t in range(M + S - 1):
        first = [a[min(t, M - 1)] for a in x_mb]
        inp = [torch.where(first_stage, f, c) for f, c in zip(first, carry)]
        # a real microbatch: all mb rows; a bubble: none (zeros sent on)
        n = mb if 0 <= t - idx < M else 0
        done = apply_local([a[:n] for a in inp])
        out = [torch.cat([d, torch.zeros((mb - n,) + tuple(d.shape[1:]), dtype=d.dtype,
                                         device=d.device)]) for d in done]
        if t >= S - 1:
            outs.append(out)
        carry = ring_shift(out, mesh)
    ys = []
    for k, a in enumerate(xs):
        y = torch.stack([o[k] for o in outs]).reshape(a.shape)
        ys.append(reduce_from_model(torch.where(last_stage, y, torch.zeros_like(y)), mesh))
    return type(x)(ys) if isinstance(x, tuple) else ys


def sequential(block_apply: Callable, stacked_params, x):
    """Reference semantics of :func:`gpipe`: the same stacked blocks applied
    one after another on one device (parity tests, one-device runs)."""
    h = x
    for j in range(_depth(stacked_params)):
        h = block_apply(tree_map(lambda a: a[j], stacked_params), h)
    return h
