"""Meshes over ``torch.distributed``: the data-parallel strategies, tensor
and expert parallelism, and pipeline and sequence parallelism.

Counterpart of ``betty_tpu/parallel/mesh.py``. The JAX package drives every
device from one process and XLA's partitioner inserts the collectives. The
port runs one process a card (``torchrun``, or the JAX package's
``BETTY_*`` variables) and makes each of those collectives explicit
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
* **tp** (Megatron tensor parallelism): ``params``, ``grad_acc``,
  ``last_grad`` and ``opt_state`` sharded over the model axis by
  ``tp_shardings`` (the JAX package's Megatron rules on the port's leaf
  names, ``Config.shard_rules`` first). The update computes on the local
  shards: the transformer's attention on its rank's heads and its MLP
  column- then row-parallel (``models/transformer.py``), the MoE on its
  rank's experts (``models/moe.py``); every other sharded leaf is gathered
  where it is used (``Problem.forward``). The optimizer steps the shards.
* **ep**: the expert-stacked MoE leaves (``moe/w1``, ``moe/b1``, ...)
  sharded over the ``ep`` axis, everything else replicated
  (``ep_rules``); a program none of whose problems has such leaves raises.
* **pp** (GPipe): the stage-stacked ``blocks.*`` leaves of
  ``models.make_pipelined_transformer`` (a leading depth dim) sharded on
  that dim over the ``pp`` axis, everything else replicated (``pp_rules``);
  the module runs its stack through ``parallel/pipeline.py::gpipe``, and a
  program none of whose problems has such leaves raises. ``strategy="tp"``
  with ``Config.shard_rules=((r"^blocks", ("pp",)),)`` gives the same
  layout.
* **sp** (sequence parallelism): parameters replicated; a module built with
  ``seq_axis="sp"`` splits its activations on the sequence over the ``sp``
  axis. ``strategy="dp"`` on a ``(("dp", N), ("sp", M))`` mesh runs it too,
  as the JAX tutorial does.

A fsdp leaf is sharded by ``fsdp_shardings``'s rule (the JAX package's):
its largest dimension divisible by the ``dp`` axis size, if it has
``min_size`` (2**14) elements or more; a shard is a contiguous chunk of
that dimension, chunk ``i`` on the rank at ``dp`` coordinate ``i``. A tp or
ep leaf is cut the same way along its shard dim over the model axis.

A mesh has a ``dp`` axis, optionally a ``dcn`` axis before it and up to
four different model axes (``mdl``, ``ep``, ``pp``, ``sp``) after it:
``EngineConfig.mesh_shape=(("dcn", 2), ("dp", 4))``, ``(("dp", 2), ("mdl",
4))``, the JAX package's composition ``(("dp", 2), ("mdl", 2), ("pp",
2))`` or ``(("dp", 1), ("mdl", 2), ("pp", 2), ("sp", 2))``. Ranks are laid
out row-major, the last axis innermost, as JAX's ``make_mesh`` reshapes the
devices: rank = (dcn index x dp size + dp index) x model size + model
index, and the model index is row-major over the model axes in the mesh's
order. The batch rides ``dcn`` and ``dp``: every reduction over the batch
goes over the *batch group* (the ranks at this rank's model coordinates),
and the model-axis collectives over the *model group* (the ranks at this
rank's dcn and dp index, every model axis). ZeRO/FSDP shards live on
``dp`` and are replicated across ``dcn``. The ranks of a ``pp`` or ``sp``
group share one batch, as those of a ``mdl`` group do.

On several model axes every non-empty subset of them has its groups too
(the ranks at this rank's batch index and its coordinates on the other
model axes; ``subset_ranks`` lists them), and ``Mesh.over(axes)`` is the
mesh seen along a subset: its ``model_group``, ``model_size`` and
``model_index`` are the subset's, its batch coordinates the mesh's;
``Mesh.view(axis)`` is ``over`` of one axis. ``tp_mesh()`` and
``axis_mesh("pp")`` return views, so the model-axis collectives run over
one axis unchanged, and a sum over the ranks of a leaf's cut axes goes
over those axes alone: on three axes the third axis's ranks hold the same
partial sums and stay out of it. A leaf is cut on a dim for each axis
(``Cut``: on ``dp x mdl x pp`` the stage dim over ``pp`` and the head or
column dim over ``mdl``). The compositions computed:

* ``mdl x pp`` on ``models.make_pipelined_transformer``: Megatron tensor
  parallelism inside each GPipe stage (``models.COMPOSED_SHARD_RULES``);
* ``mdl x sp`` on the same module built with ``seq_axis="sp"``:
  Megatron-SP, the heads and MLP columns over ``mdl`` and the positions
  over ``sp`` (``models.SP_COMPOSED_SHARD_RULES``);
* ``ep x mdl`` on the Switch MoE (``models/moe.py``): the experts over
  ``ep`` and each expert's hidden columns over ``mdl``
  (``MOE_COMPOSED_SHARD_RULES``);
* an axis a module does not split repeats its work: ``sp`` beside ``pp``
  (pipelining wins, as in JAX), ``ep`` beside the encoder, ``pp`` or ``sp``
  beside the MoE. So on three or four model axes each module computes its
  composition above and the other axes repeat it: ``mdl x pp x sp`` is
  Megatron inside GPipe stages, ``mdl x sp x ep`` Megatron-SP, ``ep x mdl
  x pp`` and ``ep x mdl x pp x sp`` the MoE's experts and columns.

The engine binds its mesh while a problem's update, loss or forward runs
(``active``); the collectives, ``models/batchnorm.py``'s global statistics,
the global weight normaliser of ``examples/bert_data_reweighting.py``
(``global_mean``), the dropout rows and the tp/ep modules read it there
(``current``). Outside such a scope every helper is the identity.
"""

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from betty_tpu_torch.utils import tree_map, tree_map_named, tree_paths

DP_STRATEGIES = ("dp", "distributed", "zero", "fsdp")
MODEL_STRATEGIES = ("tp", "ep", "pp", "sp")
MODEL_AXES = ("mdl", "ep", "pp", "sp")
# the axes a module computes tensor-parallel shards over (the transformer's
# heads and MLP columns, the MoE's experts); pp and sp split the depth and
# the sequence instead
TP_AXES = ("mdl", "ep")
DEFAULT_TIMEOUT_SECONDS = 600.0
# the engine's FSDP/ZeRO threshold: leaves under it stay replicated
FSDP_MIN_SIZE = 2**14


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
    """Ranks on named axes: ``("dp", n)``, with an optional ``("dcn", k)``
    before it and up to four different model axes (``"mdl" | "ep" | "pp" |
    "sp"``) after it.
    ``group`` spans every rank (``None``: the default group);
    ``batch_group`` the ranks at this rank's model coordinates, over which
    the batch reductions go (``None`` without a model axis: every rank);
    ``model_group`` the ranks at this rank's dcn and dp index (every model
    axis; in a view, the viewed axes' ranks); ``dp_group`` the ranks of
    this rank's dcn slice (and model coordinates), over which ZeRO/FSDP
    shard; ``dcn_group`` the ranks at this rank's dp (and model)
    coordinates. ``axis_groups``: on several model axes, the group of
    each non-empty subset of them (keyed by ``group_key``: an axis's name,
    ``"ep+mdl"`` for a pair in the mesh's order, ``"model"`` for every
    model axis); ``view_axes``: the axes a view (``over``) sees, in the
    mesh's order (empty: the whole mesh)."""

    axes: Tuple[Tuple[str, int], ...]
    rank: int
    world: int
    group: Optional[object] = None
    dp_group: Optional[object] = None
    dcn_group: Optional[object] = None
    batch_group: Optional[object] = None
    model_group: Optional[object] = None
    axis_groups: Dict[str, object] = field(default_factory=dict, repr=False)
    view_axes: Tuple[str, ...] = ()
    _views: Dict[Tuple[str, ...], "Mesh"] = field(default_factory=dict, repr=False)

    @property
    def shape(self):
        return dict(self.axes)

    @property
    def model_axes(self) -> Tuple[str, ...]:
        """The model axes, in the mesh's order."""
        return tuple(n for n, _ in self.axes if n in MODEL_AXES)

    @property
    def composed(self) -> bool:
        """Two or more model axes (the JAX package's ``dp x mdl x pp``)."""
        return len(self.model_axes) > 1

    @property
    def _seen(self) -> Tuple[str, ...]:
        return self.view_axes or self.model_axes

    @property
    def model_axis(self) -> Optional[str]:
        """``"mdl"``, ``"ep"``, ``"pp"`` or ``"sp"``: the model axis, or the
        viewed one (None for a data-parallel mesh, and for a mesh or a view
        that sees several model axes)."""
        seen = self._seen
        return seen[0] if len(seen) == 1 else None

    @property
    def _model_world(self) -> int:
        return math.prod(self.shape[a] for a in self.model_axes)

    @property
    def model_size(self) -> int:
        """The ranks of the model group (a view's: its axes')."""
        return math.prod(self.shape[a] for a in self._seen)

    @property
    def model_index(self) -> int:
        """This rank's place in the model group: row-major over the seen
        axes in the mesh's order."""
        if not self.view_axes:
            return self.rank % self._model_world
        index = 0
        for a in self.view_axes:
            index = index * self.shape[a] + self.axis_index(a)
        return index

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on the model axis ``axis``."""
        inner = math.prod(self.shape[a] for a in self.model_axes[self.model_axes.index(axis) + 1:])
        return (self.rank // inner) % self.shape[axis]

    @property
    def batch_world(self) -> int:
        """The ranks a batch is split over (dcn x dp)."""
        return self.world // self._model_world

    @property
    def batch_index(self) -> int:
        """This rank's place among them: dcn index x dp size + dp index."""
        return self.rank // self._model_world

    @property
    def dp_size(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def dp_index(self) -> int:
        return self.batch_index % self.dp_size

    @property
    def dcn_size(self) -> int:
        return self.shape.get("dcn", 1)

    def view(self, axis: str) -> "Mesh":
        """The mesh seen along the model axis ``axis``: its model group,
        size and index are that axis's (this mesh on one model axis)."""
        if axis not in self.model_axes:
            raise ValueError(f"mesh {self.axes} has no model axis {axis!r}")
        return self.over((axis,))

    def over(self, axes) -> "Mesh":
        """The mesh seen along the model axes ``axes`` (a subset, in any
        order; the others the mesh has not are ignored): its model group is
        the ranks at this rank's batch index and coordinates on the other
        model axes, its size and index the subset's. Every model axis: the
        whole mesh; none: this mesh."""
        axes = tuple(a for a in self.model_axes if a in set(axes))
        if not axes:
            return self
        key = () if axes == self.model_axes else axes
        if key == self.view_axes:
            return self
        if key not in self._views:
            self._views[key] = dataclasses.replace(
                self, view_axes=key, model_group=self.axis_groups.get(group_key(axes, self)))
        return self._views[key]


def group_key(axes, mesh) -> str:
    """The ``Mesh.axis_groups`` key of the model axes ``axes`` (in the
    mesh's order): the axis's name for one, ``"model"`` for every model
    axis, the names joined by ``+`` otherwise."""
    axes = tuple(axes)
    if axes == mesh.model_axes:
        return "model"
    return "+".join(axes)


def subset_ranks(axes, subset) -> list:
    """The groups of the model axes ``subset`` on a mesh of ``axes`` (no
    process group needed): for each batch index, and each coordinate of the
    other model axes in row-major order, the ranks that differ only in
    their ``subset`` coordinates, ascending. The order in which
    ``make_mesh`` makes them."""
    shape = dict(axes)
    model = [n for n, _ in axes if n in MODEL_AXES]
    subset = [a for a in model if a in set(subset)]
    rest = [a for a in model if a not in subset]
    m = math.prod(shape[a] for a in model)
    stride = {a: math.prod(shape[x] for x in model[i + 1:]) for i, a in enumerate(model)}
    out = []
    for b in range(math.prod(s for _, s in axes) // m):
        for other in itertools.product(*(range(shape[a]) for a in rest)):
            base = b * m + sum(c * stride[a] for a, c in zip(rest, other))
            out.append([base + sum(c * stride[a] for a, c in zip(subset, coords))
                        for coords in itertools.product(*(range(shape[a]) for a in subset))])
    return out


def check_axes(mesh_shape):
    """Raise for a ``mesh_shape`` that ``make_mesh`` does not lay out (no
    process group needed; None is the default mesh)."""
    if mesh_shape is None:
        return
    names = [str(n) for n, _ in mesh_shape]
    for n in names:
        if n not in ("dcn", "dp") + MODEL_AXES:
            raise ValueError(f"mesh axis {n!r}: the axes are 'dcn', 'dp', 'mdl', 'ep', 'pp' "
                             "and 'sp'")
    core = [n for n in names if n not in MODEL_AXES]
    model = [n for n in names if n in MODEL_AXES]
    if core not in (["dp"], ["dcn", "dp"]) or names[len(core):] != model or \
            len(set(model)) != len(model):
        raise ValueError(f"mesh {tuple(mesh_shape)}: a 'dp' axis, with an optional 'dcn' axis "
                         "before it and up to four different model axes ('mdl', 'ep', 'pp' "
                         "and 'sp') after it")


def make_mesh(mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None) -> Mesh:
    """The mesh over the process group's ranks. Default: all ranks on one
    ``dp`` axis. Joins the group first (``maybe_init_distributed``) if
    there is none. Every rank must call it, in the same order as its other
    group calls (sub-groups are made here)."""
    check_axes(mesh_shape)
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
    m, dp, dcn = mesh.model_size, mesh.dp_size, mesh.dcn_size
    # every rank makes every group, in one order
    if "dcn" in names:
        for i in range(dcn):
            for j in range(m):
                g = dist.new_group([(i * dp + k) * m + j for k in range(dp)])
                if i == mesh.batch_index // dp and j == mesh.model_index:
                    mesh.dp_group = g
        for k in range(dp):
            for j in range(m):
                g = dist.new_group([(i * dp + k) * m + j for i in range(dcn)])
                if k == mesh.dp_index and j == mesh.model_index:
                    mesh.dcn_group = g
    if mesh.model_axes:
        batch = world // m
        for j in range(m):
            g = dist.new_group([b * m + j for b in range(batch)])
            if j == mesh.model_index:
                mesh.batch_group = g
        for b in range(batch):
            g = dist.new_group([b * m + j for j in range(m)])
            if b == mesh.batch_index:
                mesh.model_group = g
        if mesh.composed:
            mesh.axis_groups["model"] = mesh.model_group
            model = mesh.model_axes
            # the proper subsets, smallest first, each in the mesh's order
            subsets = [c for r in range(1, len(model)) for c in itertools.combinations(model, r)]
            for subset in subsets:
                for ranks in subset_ranks(axes, subset):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        mesh.axis_groups[group_key(subset, mesh)] = g
        if dcn == 1:
            mesh.dp_group = mesh.batch_group
    return mesh


def mesh_shape(spec):
    """``EngineConfig.mesh_shape`` of ``--mesh`` (``"dp:4"``,
    ``"dcn:2,dp:4"`` or ``"dp:2,mdl:4"``, the JAX example's format; a model
    axis alone, ``"mdl:4"``, gets a ``dp`` axis of 1 before it), or None."""
    if not spec:
        return None
    axes = tuple((name, int(size)) for name, size in (ax.split(":") for ax in spec.split(",")))
    if "dp" not in dict(axes):
        axes = (("dp", 1),) + axes
    return axes


def batch_coordinates(mesh_shape=None) -> Tuple[int, int]:
    """``(batch index, batch world)`` of this process on a mesh of
    ``mesh_shape`` (no groups made): which slice of a global batch this
    rank loads. ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    m = math.prod(int(s) for n, s in (mesh_shape or ()) if n in MODEL_AXES)
    return rank // m, world // m


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
        if set(self.axes) <= set(MODEL_AXES):
            idx = self.mesh.over(self.axes).model_index
        elif n == self.mesh.batch_world:
            idx = self.mesh.batch_index
        else:
            idx = self.mesh.dp_index
        return x.chunk(n, dim=self.dim)[idx]


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, axis=None) -> Sharding:
    """The batch (leading axis) split over ``("dcn", "dp")`` (every batch
    rank) or ``"dp"``: ``local(global_batch)`` is this rank's contiguous
    slice."""
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
    return _largest_dim(tuple(x.shape), axis_size)


def _largest_dim(shape, axis_size: int) -> Optional[int]:
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
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


# ---------------------------------------------------------------------------
# tp and ep layouts (``betty_tpu/parallel/mesh.py:99-280``) on the port's
# leaf names: a nested dict's keys joined by "/", a torch module's
# parameters by their own dotted names (``blocks.0.attn.query.kernel``), as
# ``param_groups`` selectors see them
# ---------------------------------------------------------------------------

# The JAX package's Megatron rules, translated to the port's names. The
# attention kernels keep flax's shapes, so their specs are the same: q/k/v
# kernels (d, H, Dh) and biases (H, Dh) sharded on dim 1 (heads, and Dh for
# the bias, as JAX's rule gives), the out kernel (H, Dh, d) on heads, the
# out bias replicated, the token embedding (V, d) on the vocabulary.
_TP_RULES = (
    (re.compile(r"(query|key|value)\.(kernel|bias)$"),
     lambda x: 1 if x.dim() in (2, 3) else None),
    (re.compile(r"out\.kernel$"), lambda x: 0 if x.dim() == 3 else None),
    (re.compile(r"out\.bias$"), lambda x: ()),
    (re.compile(r"(^|[./])embed\.weight$"), lambda x: 0 if x.dim() == 2 else None),
)
TP_MIN_SIZE = 2**12

# Expert-stacked MoE leaves (``models/moe.py``'s layout, the JAX package's
# ``_MOE_EXPERT_LEAF``): one definition for the sharder, the matcher and
# the module that computes on them.
MOE_EXPERT_LEAF = re.compile(r"(^|/)moe/(w[0-9]+|b[0-9]+)$")
# The MoE on ``(dp, ep, mdl)``: tests/test_ep.py's rules with the ``mdl`` dim
# added, the experts over ``ep`` and each expert's hidden columns over
# ``mdl`` (``w1`` [E, d, h], ``b1`` [E, h], ``w2`` [E, h, d]; ``b2`` [E, d]
# on ``ep`` alone), the rest whole
MOE_COMPOSED_SHARD_RULES = (
    (r"(^|/)moe/w1$", ("ep", None, "mdl")),
    (r"(^|/)moe/b1$", ("ep", "mdl")),
    (r"(^|/)moe/w2$", ("ep", "mdl", None)),
    (r"(^|/)moe/b2$", ("ep",)),
    (r".*", ()),
)
# the dim of each expert leaf that the hidden axis cuts beside the experts
_MOE_HIDDEN_DIMS = {"w1": 2, "b1": 1, "w2": 1}


def moe_axes(mesh) -> Tuple[Optional[str], Optional[str]]:
    """``(expert axis, hidden axis)`` the MoE splits over on ``mesh``: the
    experts over ``ep`` (else ``mdl``), and beside ``ep`` each expert's
    hidden columns over ``mdl``; None where the mesh has no such axis (the
    ``pp`` and ``sp`` ranks repeat the layer)."""
    axes = () if mesh is None else mesh.model_axes
    if "ep" in axes:
        return "ep", ("mdl" if "mdl" in axes else None)
    return ("mdl" if "mdl" in axes else None), None


def moe_local_dim(name: str, mesh=None):
    """The dim ``models/moe.py`` computes an expert leaf ``name`` on as a
    shard (the expert dim), or on several model axes its ``Cut`` (``w1`` on
    ``((0, "ep"), (2, "mdl"))`` on ``(dp, ep, mdl)``); None for another
    leaf, or a mesh without an expert axis."""
    if not MOE_EXPERT_LEAF.search(name):
        return None
    if mesh is None or not mesh.composed:
        return 0
    expert, hidden = moe_axes(mesh)
    if expert is None:
        return None
    leaf = name.rsplit("/", 1)[-1]
    extra = ((_MOE_HIDDEN_DIMS[leaf], hidden),) if hidden and leaf in _MOE_HIDDEN_DIMS else ()
    return Cut(((0, expert),) + extra)


def path_str(path) -> str:
    """A leaf's name: its keys joined by "/"."""
    return "/".join(str(k) for k in path)


def _flax_order(name: str, x) -> Tuple[int, ...]:
    """The port's dims in the order of the flax tensor they hold: an
    ``nn.Linear`` weight (out, in) is a flax kernel (in, out), a conv
    weight (out, in, kh, kw) one of (kh, kw, in, out). So the largest-dim
    rule breaks a tie (a square kernel) on the axis JAX's rule takes."""
    if name.endswith("weight") and not re.search(r"(^|[./])embed\.weight$", name):
        if x.dim() == 2:
            return (1, 0)
        if x.dim() == 4:
            return (2, 3, 1, 0)
    return tuple(range(x.dim()))


@dataclass(frozen=True)
class Cut:
    """A leaf's shard on a mesh with several model axes: cut along dim
    ``pairs[k][0]`` over model axis ``pairs[k][1]`` for each k (chunk ``i``
    of a dim on the rank at that axis's coordinate ``i``). A leaf of a
    tree of shard dims, where one model axis has an int."""

    pairs: Tuple[Tuple[int, str], ...]

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for _, a in self.pairs)


def cut_pairs(d, mesh: Mesh, axis: str = "model") -> Tuple[Tuple[int, str], ...]:
    """``((dim, axis name), ...)`` of a shard dim ``d`` (None, an int over
    ``axis``: ``"model"``, the mesh's model axis, or ``"dp"``; or a
    ``Cut``)."""
    if d is None:
        return ()
    if isinstance(d, Cut):
        return d.pairs
    return ((d, mesh.model_axis if axis == "model" else "dp"),)


def _axis_size_index(mesh: Mesh, name: str):
    if name == "dp":
        return mesh.dp_size, mesh.dp_index
    return mesh.shape[name], mesh.axis_index(name)


def _spec_dim(name, x, spec, mesh: Mesh):
    """The dim a partition-spec tuple shards ``x`` on, if the spec fits
    (each named dim divisible by the size of its axes): an int on one model
    axis, a ``Cut`` on several (each model axis named at most once); raises for
    a spec the port cannot lay out (more than one sharded dim on one model
    axis, an axis other than the model axes, two axes on one dim)."""
    dims = []
    for d, names in enumerate(spec):
        if names is None:
            continue
        ns = names if isinstance(names, tuple) else (names,)
        for n in ns:
            if n not in mesh.shape:
                raise ValueError(f"shard rule for {name!r}: axis {n!r} is not on the mesh "
                                 f"{mesh.axes}")
        if d >= x.dim() or x.shape[d] % math.prod(mesh.shape[n] for n in ns):
            return False
        dims.append((d, ns))
    if not dims:
        return None
    if not mesh.composed:
        if len(dims) > 1 or dims[0][1] != (mesh.model_axis,):
            raise ValueError(f"shard rule {tuple(spec)} for {name!r}: the port shards a leaf "
                             f"along one dim over the model axis {mesh.model_axis!r} only")
        return dims[0][0]
    named = [ns for _, ns in dims]
    if any(len(ns) != 1 or ns[0] not in mesh.model_axes for ns in named) or \
            len({ns[0] for ns in named}) != len(named):
        raise ValueError(f"shard rule {tuple(spec)} for {name!r}: on the mesh {mesh.axes} the "
                         f"port cuts a leaf along one dim for each model axis "
                         f"{mesh.model_axes}, each named once")
    return Cut(tuple((d, ns[0]) for d, ns in dims))


def tp_shardings(tree, mesh: Mesh, axis: Optional[str] = None, min_size: int = TP_MIN_SIZE,
                 rules: Optional[Sequence] = None):
    """The dim each leaf of ``tree`` is sharded on over the model axis (None:
    replicated), by Megatron's rules (``betty_tpu/parallel/mesh.py:159-195``).

    ``rules`` (``Config.shard_rules``) are checked first: ``(regex,
    partition-spec tuple)`` pairs, the regex searched in the leaf's name,
    the spec naming the port's dims (``(None, "mdl")`` shards dim 1); the
    first that fits wins. Then the default rules (``_TP_RULES``), then
    leaves under ``min_size`` elements stay replicated and larger ones take
    the largest-dim rule, on the flax layout of the tensor (``_flax_order``).
    ``axis``: the model axis (default the mesh's).

    On a ``pp`` or ``sp`` axis, and on several model axes, only ``rules``
    shard: a leaf no rule names stays replicated (the JAX package's
    ``tp_shardings`` would shard it over ``dp`` by the Megatron rules,
    ``betty_tpu/parallel/mesh.py:173-174``; the port shards over the model
    axes only, and the pipelined module computes on whole leaves outside
    its stacked blocks). On several model axes a sharded leaf's dims are a
    ``Cut``: ``("pp", None, "mdl", None)`` cuts dim 0 over ``pp`` and dim
    2 over ``mdl``."""
    if not mesh.model_axes:
        raise ValueError(f"tp layouts need a model axis ('mdl', 'ep', 'pp' or 'sp') on the mesh "
                         f"{mesh.axes}")
    axis = axis or mesh.model_axis
    user = tuple((re.compile(pat), tuple(spec)) for pat, spec in (rules or ()))
    # several model axes: the rules alone shard
    rules_only = axis not in TP_AXES
    size = 1 if axis is None else mesh.shape[axis]

    def dim_for(name, x):
        if not isinstance(x, torch.Tensor):
            return None
        for pat, spec in user:
            if pat.search(name):
                d = _spec_dim(name, x, spec, mesh)
                if d is not False:
                    return d
        if rules_only:
            return None
        for pat, fn in _TP_RULES:
            if pat.search(name):
                spec = fn(x)
                if spec == ():
                    return None
                if spec is not None and x.shape[spec] % size == 0:
                    return spec
        if x.dim() == 0 or x.numel() < min_size:
            return None
        order = _flax_order(name, x)
        d = _largest_dim(tuple(x.shape[i] for i in order), size)
        return None if d is None else order[d]

    return tree_map_named(dim_for, tree)


def ep_rules(state, mesh: Mesh):
    """``strategy="ep"``'s rules (``_ep_rules``): the expert-stacked MoE
    leaves sharded on their expert dim over ``ep``, everything else
    replicated; None for a state with no such leaf (its problem stays
    replicated). Beside a ``mdl`` axis the leaves stay whole over it (the
    JAX package's placement); the MoE cuts each expert's hidden columns
    over ``mdl`` where it computes (``moe_local_dim``).
    ``MOE_COMPOSED_SHARD_RULES`` under ``strategy="tp"`` holds them cut so."""
    if "ep" not in mesh.shape:
        raise ValueError("strategy='ep' needs a mesh with an 'ep' axis: pass "
                         "EngineConfig(mesh_shape=(('dp', N), ('ep', M))) "
                         f"(got axes {tuple(mesh.shape)})")
    size = mesh.shape["ep"]
    matched = [(path_str(p), x) for p, x in tree_paths(state.get("params", {}))
               if isinstance(x, torch.Tensor) and MOE_EXPERT_LEAF.search(path_str(p))]
    if not matched:
        return None
    for name, x in matched:
        if x.shape[0] % size:
            raise ValueError(f"strategy='ep': {name} has {x.shape[0]} experts, not divisible "
                             f"by the ep axis size {size}")
    return ((MOE_EXPERT_LEAF.pattern, ("ep",)), (r".*", ()))


# Stage-stacked block leaves (``models.make_pipelined_transformer``'s
# layout: ``blocks.ln1.weight`` with a leading depth dim, not
# ``TransformerClassifier``'s ``blocks.0.ln1.weight``), the JAX package's
# ``params["blocks"]``
PP_STACKED_LEAF = re.compile(r"^blocks[./](?![0-9]+[./])")


def _stacked_blocks(state):
    return [(path_str(p), x) for p, x in tree_paths(state.get("params") or {})
            if isinstance(x, torch.Tensor) and PP_STACKED_LEAF.search(path_str(p))]


def pp_rules(state, mesh: Mesh):
    """``strategy="pp"``'s rules (``_pp_rules``,
    ``betty_tpu/parallel/mesh.py:203-235``): the stage-stacked ``blocks.*``
    leaves sharded on their depth dim over ``pp``, everything else
    replicated; None for a state without such leaves (its problem stays
    replicated)."""
    if "pp" not in mesh.shape:
        raise ValueError("strategy='pp' needs a mesh with a 'pp' axis: pass "
                         "EngineConfig(mesh_shape=(('dp', N), ('pp', M))) "
                         f"(got axes {tuple(mesh.shape)})")
    matched = _stacked_blocks(state)
    if not matched:
        return None
    size = mesh.shape["pp"]
    for name, x in matched:
        if x.dim() == 0 or x.shape[0] % size:
            raise ValueError(f"strategy='pp': stacked depth {x.shape[0] if x.dim() else 0} of "
                             f"{name} is not divisible by the pp axis size {size}")
    return ((PP_STACKED_LEAF.pattern, ("pp",)), (r".*", ()))


def strategy_matches(strategy: str, state) -> bool:
    """Whether a problem's state has the layout ``strategy`` shards (pp:
    stage-stacked ``blocks.*`` leaves; ep: expert-stacked ``moe/*``
    leaves)."""
    if strategy == "pp":
        return bool(_stacked_blocks(state))
    if strategy == "ep":
        return any(isinstance(x, torch.Tensor) and MOE_EXPERT_LEAF.search(path_str(p))
                   for p, x in tree_paths(state.get("params") or {}))
    return True


SHARDED_KEYS = {"zero": ("opt_state",),
                "fsdp": ("params", "grad_acc", "last_grad", "opt_state"),
                "tp": ("params", "grad_acc", "last_grad", "opt_state"),
                "ep": ("params", "grad_acc", "last_grad", "opt_state"),
                "pp": ("params", "grad_acc", "last_grad", "opt_state"),
                "sp": ()}


def shard_axis(strategy: str) -> str:
    """The axis a strategy's shards live on: ``"model"`` under tp/ep/pp/sp,
    ``"dp"`` otherwise."""
    return "model" if strategy in MODEL_STRATEGIES else "dp"


def state_shard_dims(state, mesh: Mesh, strategy: str = "dp", rules=None):
    """``{state key: tree of shard dims}`` for the keys ``strategy`` shards
    (``betty_tpu/parallel/mesh.py:314-346``): none under dp/distributed;
    ``opt_state`` under zero; ``params``, ``grad_acc``, ``last_grad`` and
    ``opt_state`` under fsdp (leaves of ``FSDP_MIN_SIZE`` elements or more,
    over ``dp``), tp (``tp_shardings`` with ``rules``, over the model axis),
    ep (``ep_rules``; nothing for a state without MoE leaves) and pp
    (``pp_rules``; nothing for a state without stacked blocks); none under
    sp, whose parameters are replicated. ``extra`` and ``sched_step`` stay
    replicated."""
    if strategy in ("dp", "distributed", "default"):
        return {}
    if strategy not in SHARDED_KEYS:
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "sp":
        if "sp" not in mesh.shape:
            raise ValueError("strategy='sp' needs a mesh with an 'sp' axis: pass "
                             "EngineConfig(mesh_shape=(('dp', N), ('sp', M))) and build the "
                             f"module with seq_axis='sp' (got axes {tuple(mesh.shape)})")
        return {}
    if strategy in ("ep", "pp"):
        rules = (ep_rules if strategy == "ep" else pp_rules)(state, mesh)
        if rules is None:
            return {}
    if strategy in MODEL_STRATEGIES:
        params = state.get("params", {})
        pdims = tp_shardings(params, mesh, rules=rules)
        return {k: _like_params(state[k], params, pdims,
                                tp_shardings(state[k], mesh, rules=rules))
                for k in SHARDED_KEYS[strategy] if k in state}
    return {k: fsdp_shardings(state[k], mesh, min_size=FSDP_MIN_SIZE)
            for k in SHARDED_KEYS[strategy] if k in state}


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_structure(x, y) for x, y in zip(a, b))
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.shape == b.shape


def _like_params(tree, params, pdims, default):
    """The shard dims of ``tree`` (``grad_acc``, ``last_grad``,
    ``opt_state``): every subtree shaped as ``params`` (a gradient, an Adam
    moment) takes the parameters' dims, so a rule anchored at a parameter's
    name (``^blocks``) shards its moments alike; elsewhere ``default`` (the
    rules on ``tree``'s own names)."""
    if _same_structure(tree, params):
        return pdims
    if isinstance(tree, dict):
        return {k: _like_params(v, params, pdims, default[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like_params(v, params, pdims, d) for v, d in zip(tree, default))
    return default


def shard_tree(tree, dims, mesh: Mesh, axis: str = "dp"):
    """This rank's shard of every leaf of ``tree`` with a dim in ``dims``
    (a contiguous copy) over ``axis`` (``"dp"`` or ``"model"``; a ``Cut``
    along each of its dims over its axis); other leaves unchanged."""
    if dims is None:
        return tree

    def take(x, d):
        pairs = cut_pairs(d, mesh, axis)
        if not pairs:
            return x
        for dim, name in pairs:
            n, idx = _axis_size_index(mesh, name)
            x = x.chunk(n, dim=dim)[idx]
        return x.contiguous()

    return tree_map(take, tree, dims)


def full_shape_like(tree, dims, mesh: Mesh, axis: str = "dp"):
    """Empty tensors of the whole shape in place of the shards of ``tree``
    (templates for a checkpoint restore; no communication)."""
    if dims is None:
        return tree

    def full(x, d):
        pairs = cut_pairs(d, mesh, axis)
        if not pairs:
            return x
        shape = list(x.shape)
        for dim, name in pairs:
            shape[dim] *= _axis_size_index(mesh, name)[0]
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    return tree_map(full, tree, dims)


def shard_state(state, mesh: Mesh, strategy: str = "dp", rules=None):
    """One problem's state placed for ``strategy``: the keys of
    ``state_shard_dims`` cut to this rank's shards, the rest as is
    (replicated: every rank builds it from the same seed)."""
    out = dict(state)
    axis = shard_axis(strategy)
    for k, dims in state_shard_dims(state, mesh, strategy, rules).items():
        out[k] = shard_tree(state[k], dims, mesh, axis)
    return out


def make_global_batch(local_batch, mesh: Mesh, axis=None):
    """The global batch, on every rank: the batch ranks' local batches
    concatenated along the leading axis in rank order, as JAX's
    ``make_array_from_process_local_data`` lays them out (``axis``: the
    batch axes, default ``dcn`` and ``dp``)."""
    from betty_tpu_torch.parallel.collectives import all_gather_cat

    sharding = batch_sharding(mesh, axis)
    every = len(sharding.axes) == len([n for n, _ in mesh.axes if n not in MODEL_AXES])
    group = mesh.batch_group if every else mesh.dp_group
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


def batch_world() -> int:
    """The batch ranks of the bound mesh, dcn x dp (1 without one)."""
    return 1 if _ACTIVE is None else _ACTIVE.batch_world


def batch_rank() -> int:
    """This rank's batch index in the bound mesh (0 without one)."""
    return 0 if _ACTIVE is None else _ACTIVE.batch_index


def model_mesh() -> Optional[Mesh]:
    """The bound mesh if it has a model axis (tp/ep/pp/sp), else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.model_axes else None


def tp_view(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` seen along its axis that splits tensors (``mdl`` or ``ep``:
    tp's heads and MLP columns, ep's experts; ``mdl`` where it has both),
    else None."""
    axis = None if mesh is None else next((a for a in TP_AXES if a in mesh.model_axes), None)
    return None if axis is None else mesh.view(axis)


def tp_mesh() -> Optional[Mesh]:
    """The bound mesh seen along its axis that splits tensors
    (``tp_view``), else None."""
    return tp_view(_ACTIVE)


def axis_mesh(axis: str) -> Optional[Mesh]:
    """The bound mesh seen along its model axis ``axis`` (``"pp"``,
    ``"sp"``, ``"mdl"``), else None."""
    return _ACTIVE.view(axis) if _ACTIVE is not None and axis in _ACTIVE.model_axes else None


def is_rank_zero() -> bool:
    """Rank 0 of the process group, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_rows(shape, draw, dim: int = 0):
    """This rank's rows of a draw over the global batch: ``draw(global
    shape)`` with the batch axis ``dim`` ``shape[dim] x batch world`` long,
    rows ``batch index::batch world`` kept (the ranks' local batches hold
    the global batch's examples so under ``shard_loader`` with
    ``shuffle=False``; the ranks of one model group draw the same rows).
    With no mesh this is ``draw(shape)``."""
    w = batch_world()
    shape = list(shape)
    shape[dim] *= w
    idx = [slice(None)] * len(shape)
    idx[dim] = slice(batch_rank(), None, w)
    return draw(tuple(shape))[tuple(idx)]
