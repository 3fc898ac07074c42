"""Data-parallel meshes over ``torch.distributed``.

Counterpart of the data-parallel half of ``betty_tpu/parallel/mesh.py``.
The JAX package drives every device from one process and XLA's partitioner
inserts the collectives. The port runs one process a card (``torchrun``,
or the JAX package's ``BETTY_*`` variables) and makes each of those
collectives explicit, at the few places where gradients are made
(``parallel/collectives.py``):

* **dp** (``"distributed"`` is the reference Betty's name for it): every
  rank loads its own examples (``data.shard_loader``), parameters are
  replicated, and every gradient, hypergradient vector, HVP and logged loss
  is averaged over the ranks.
* **zero** (ZeRO-1): dp, and each rank keeps only its shard of the
  optimizer state; after its shard's update the new parameters are
  all-gathered.
* **fsdp**: dp, and each rank keeps only its shard of the parameters,
  ``grad_acc``, ``last_grad`` and the optimizer state. Parameters are
  all-gathered for each update, and the direct gradient of a sharded leaf
  is reduce-scattered to its shard.

A leaf is sharded by ``fsdp_shardings``'s rule (the JAX package's): its
largest dimension divisible by the ``dp`` axis size, if it has
``min_size`` (2**14) elements or more; a shard is a contiguous chunk of
that dimension, chunk ``i`` on the rank at ``dp`` coordinate ``i``.

A mesh has a ``dp`` axis and, optionally, a ``dcn`` axis before it
(``EngineConfig.mesh_shape=(("dcn", 2), ("dp", 4))``). Ranks are laid out
row-major, rank = dcn index x dp size + dp index. The batch rides both
axes; ZeRO/FSDP shards live on ``dp`` and are replicated across ``dcn``.
Meshes naming ``mdl``, ``pp``, ``ep`` or ``sp`` (tensor, pipeline, expert
and sequence parallelism) are the next slice of the port (ROADMAP.md
§A.7) and raise ``NotImplementedError``.

The engine binds its mesh while a problem's update, loss or forward runs
(``active``); the collectives, ``models/batchnorm.py``'s global statistics,
the global weight normaliser of ``examples/bert_data_reweighting.py``
(``global_mean``) and the transformer's dropout rows read it there
(``current``). Outside such a scope every helper is the identity.
"""

import contextlib
import datetime
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from betty_tpu_torch.utils import tree_map

DP_STRATEGIES = ("dp", "distributed", "zero", "fsdp")
MODEL_PARALLEL_STRATEGIES = ("tp", "pp", "ep", "sp")
MODEL_PARALLEL_AXES = ("mdl", "pp", "ep", "sp")
DEFAULT_TIMEOUT_SECONDS = 600.0
# the engine's FSDP/ZeRO threshold: leaves under it stay replicated
FSDP_MIN_SIZE = 2**14


def model_parallel_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: tensor, pipeline, expert and sequence parallelism (tp/pp/ep/sp, the "
        "mdl/pp/ep/sp mesh axes) are not ported yet (ROADMAP.md §A.7); the port runs "
        "the data-parallel strategies dp, distributed, zero and fsdp")


def maybe_init_distributed(device=None, backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_SECONDS):
    """Join (or make) the process group, once per process.

    The rank, world size and rendezvous come from the environment:

    * ``BETTY_COORDINATOR_ADDRESS`` (``host:port``) with
      ``BETTY_NUM_PROCESSES`` and ``BETTY_PROCESS_ID``, the JAX package's
      variables (``betty_tpu/parallel/mesh.py:362-397``);
    * else ``RANK`` and ``WORLD_SIZE`` with ``MASTER_ADDR``/``MASTER_PORT``
      (``torchrun``);
    * else a world of one, over an in-process store: the collectives are
      still made, over one rank.

    ``backend``: ``"nccl"`` for a CUDA ``device``, ``"gloo"`` otherwise
    (gloo also takes CUDA tensors: several ranks on one card).
    ``timeout`` (seconds, default ``DEFAULT_TIMEOUT_SECONDS``) bounds
    every collective, so a rank that is gone fails the others instead of
    hanging them. On CUDA with several cards, the rank takes card
    ``LOCAL_RANK`` (default: the rank modulo the card count). Idempotent:
    a group that exists is kept."""
    if dist.is_initialized():
        return
    env = os.environ
    device = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"timeout": datetime.timedelta(seconds=timeout)}
    if env.get("BETTY_COORDINATOR_ADDRESS"):
        rank, world = int(env["BETTY_PROCESS_ID"]), int(env["BETTY_NUM_PROCESSES"])
        kwargs["init_method"] = f"tcp://{env['BETTY_COORDINATOR_ADDRESS']}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        kwargs["init_method"] = "env://"
    else:
        rank, world = 0, 1
        kwargs["store"] = dist.HashStore()
    if device.type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)


@dataclass(eq=False)
class Mesh:
    """Ranks on named axes (``("dcn", n), ("dp", m)`` or ``("dp", m)``).
    ``group`` spans every rank (``None``: the default group); ``dp_group``
    the ranks of this rank's dcn slice, over which ZeRO/FSDP shard;
    ``dcn_group`` the ranks at this rank's dp coordinate."""

    axes: Tuple[Tuple[str, int], ...]
    rank: int
    world: int
    group: Optional[object] = None
    dp_group: Optional[object] = None
    dcn_group: Optional[object] = None

    @property
    def shape(self):
        return dict(self.axes)

    @property
    def dp_size(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def dp_index(self) -> int:
        return self.rank % self.dp_size

    @property
    def dcn_size(self) -> int:
        return self.shape.get("dcn", 1)


def make_mesh(mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None) -> Mesh:
    """The mesh over the process group's ranks. Default: all ranks on one
    ``dp`` axis. Joins the group first (``maybe_init_distributed``) if
    there is none. Every rank must call it, in the same order as its other
    group calls (sub-groups are made here)."""
    if mesh_shape is not None:
        names = [str(n) for n, _ in mesh_shape]
        for n in names:
            if n in MODEL_PARALLEL_AXES:
                raise model_parallel_error(f"mesh axis {n!r}")
            if n not in ("dcn", "dp"):
                raise ValueError(f"mesh axis {n!r}: the axes are 'dcn' and 'dp'")
        if names not in (["dp"], ["dcn", "dp"]):
            raise ValueError(f"mesh {tuple(mesh_shape)}: a 'dp' axis, with an optional 'dcn' "
                             "axis before it")
    if not dist.is_initialized():
        maybe_init_distributed()
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh_shape is None:
        mesh_shape = (("dp", world),)
    axes = tuple((str(n), int(s)) for n, s in mesh_shape)
    names = [n for n, _ in axes]
    if math.prod(s for _, s in axes) != world:
        raise ValueError(f"mesh {axes} does not cover the {world} ranks of the process group")
    mesh = Mesh(axes=axes, rank=rank, world=world)
    if "dcn" in names:
        dp, dcn = mesh.dp_size, mesh.dcn_size
        for i in range(dcn):  # every rank makes every group, in one order
            g = dist.new_group([i * dp + j for j in range(dp)])
            if i == rank // dp:
                mesh.dp_group = g
        for j in range(dp):
            g = dist.new_group([i * dp + j for i in range(dcn)])
            if j == mesh.dp_index:
                mesh.dcn_group = g
    return mesh


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: replicated (``dim`` None) or split
    along ``dim`` over the ranks of ``axes``, in rank order."""

    mesh: Mesh
    dim: Optional[int] = None
    axes: Tuple[str, ...] = ()

    def local(self, x):
        """This rank's piece of the whole tensor ``x``."""
        if self.dim is None:
            return x
        n = math.prod(self.mesh.shape[a] for a in self.axes)
        idx = self.mesh.rank if n == self.mesh.world else self.mesh.dp_index
        return x.chunk(n, dim=self.dim)[idx]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, axis=None) -> Sharding:
    """The batch (leading axis) split over ``("dcn", "dp")`` (every rank)
    or ``"dp"``: ``local(global_batch)`` is this rank's contiguous slice."""
    if axis is None:
        axis = tuple(a for a in ("dcn", "dp") if a in mesh.shape)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return Sharding(mesh, 0, axes)


def shard_dim(x, axis_size: int, min_size: int = 2**14) -> Optional[int]:
    """FSDP rule (``betty_tpu/parallel/mesh.py:71-86``): the largest
    dimension divisible by the axis size; leaves under ``min_size``
    elements (and non-tensors, scalars) stay replicated (None)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.numel() < min_size:
        return None
    for d in sorted(range(x.dim()), key=lambda d: -x.shape[d]):
        if x.shape[d] % axis_size == 0 and x.shape[d] >= axis_size:
            return d
    return None


def fsdp_shardings(tree, mesh, axis: Optional[str] = None, min_size: int = 2**14):
    """The dimension each leaf of ``tree`` is sharded on over ``axis``
    (default ``"dp"``; None for a replicated leaf). ``mesh``: a ``Mesh``
    or an axis size."""
    if axis is None:
        axis = "dp"
    size = mesh if isinstance(mesh, int) else mesh.shape[axis]
    return tree_map(lambda x: shard_dim(x, size, min_size), tree)


SHARDED_KEYS = {"zero": ("opt_state",),
                "fsdp": ("params", "grad_acc", "last_grad", "opt_state")}


def state_shard_dims(state, mesh: Mesh, strategy: str = "dp"):
    """``{state key: tree of shard dims}`` for the keys ``strategy`` shards
    (``betty_tpu/parallel/mesh.py:314-346``): none under dp/distributed;
    ``opt_state`` under zero; ``params``, ``grad_acc``, ``last_grad`` and
    ``opt_state`` under fsdp, leaves of ``FSDP_MIN_SIZE`` elements or more.
    ``extra`` and ``sched_step`` stay replicated."""
    if strategy in MODEL_PARALLEL_STRATEGIES:
        raise model_parallel_error(f"strategy {strategy!r}")
    if strategy in ("dp", "distributed", "default"):
        return {}
    if strategy not in SHARDED_KEYS:
        raise ValueError(f"unknown strategy {strategy!r}")
    return {k: fsdp_shardings(state[k], mesh, min_size=FSDP_MIN_SIZE)
            for k in SHARDED_KEYS[strategy] if k in state}


def shard_tree(tree, dims, mesh: Mesh):
    """This rank's shard of every leaf of ``tree`` with a dim in ``dims``
    (a contiguous copy); other leaves unchanged."""
    if dims is None:
        return tree

    def take(x, d):
        if d is None:
            return x
        return x.chunk(mesh.dp_size, dim=d)[mesh.dp_index].contiguous()

    return tree_map(take, tree, dims)


def full_shape_like(tree, dims, mesh: Mesh):
    """Empty tensors of the whole shape in place of the shards of ``tree``
    (templates for a checkpoint restore; no communication)."""
    if dims is None:
        return tree

    def full(x, d):
        if d is None:
            return x
        shape = list(x.shape)
        shape[d] *= mesh.dp_size
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    return tree_map(full, tree, dims)


def shard_state(state, mesh: Mesh, strategy: str = "dp"):
    """One problem's state placed for ``strategy``: the keys of
    ``state_shard_dims`` cut to this rank's shards, the rest as is
    (replicated: every rank builds it from the same seed)."""
    out = dict(state)
    for k, dims in state_shard_dims(state, mesh, strategy).items():
        out[k] = shard_tree(state[k], dims, mesh)
    return out


def make_global_batch(local_batch, mesh: Mesh, axis=None):
    """The global batch, on every rank: the ranks' local batches
    concatenated along the leading axis in rank order, as JAX's
    ``make_array_from_process_local_data`` lays them out (``axis``: the
    batch axes, default every rank)."""
    from betty_tpu_torch.parallel.collectives import all_gather_cat

    sharding = batch_sharding(mesh, axis)
    group = mesh.group if len(sharding.axes) == len(mesh.axes) else mesh.dp_group
    return tree_map(lambda x: all_gather_cat(x, group) if isinstance(x, torch.Tensor) else x,
                    local_batch)


# ---------------------------------------------------------------------------
# the mesh a problem's update runs under
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """The mesh bound by the innermost ``active`` scope, or None."""
    return _ACTIVE


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Bind ``mesh`` (None: no mesh) for the collectives of the scope."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = saved


def world_size() -> int:
    """Ranks of the bound mesh (1 without one)."""
    return 1 if _ACTIVE is None else _ACTIVE.world


def rank() -> int:
    """This rank in the bound mesh (0 without one)."""
    return 0 if _ACTIVE is None else _ACTIVE.rank


def is_rank_zero() -> bool:
    """Rank 0 of the process group, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_rows(shape, draw, dim: int = 0):
    """This rank's rows of a draw over the global batch: ``draw(global
    shape)`` with the batch axis ``dim`` ``shape[dim] x world`` long, rows
    ``rank::world`` kept (the ranks' local batches hold the global batch's
    examples ``rank::world`` under ``shard_loader`` with ``shuffle=False``).
    With no mesh this is ``draw(shape)``."""
    w = world_size()
    shape = list(shape)
    shape[dim] *= w
    idx = [slice(None)] * len(shape)
    idx[dim] = slice(rank(), None, w)
    return draw(tuple(shape))[tuple(idx)]
