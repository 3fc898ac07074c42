"""Problem: one level of a multilevel optimization program.

Counterpart of ``betty_tpu/problems/problem.py`` in driver mode. A problem's
learnable state is an explicit dict (``params / extra / opt_state / grad_acc
/ last_grad / sched_step``) owned by the Engine, and each gradient step is
a function ``update(states, batch, path_batches, itd_data, rng) -> (states,
metrics)`` that builds new tensors and never updates a state in place, so a
roll-back cache is a reference to the old state.

The user API is the JAX package's: subclass, define ``training_step(self,
batch)``, call ``self.module(x)`` and other problems by name
(``self.outer(...)``). These calls resolve parameters from a context
binding (``_CtxBinding``), so a loss is a differentiable function of
whatever parameter tensors the context holds.

Per-step randomness is an integer seed folded from the problem's name and
its step count; modules seed a ``torch.Generator`` with it.

A child that is an ``IterativeProblem`` under a parent with
``Config(first_order=False)`` is differentiated through its unroll: the
parent's update gets the child's recorded unroll as ``itd_data`` and
replaces the child's parameters in its loss by the replay
(``problems/iterative.py``).

``Config(remat=True)`` recomputes the problem's direct loss in the
backward (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``) instead
of keeping its activations; the numbers do not change.
``state_dict``/``load_state_dict`` hand the state out as host tensors and
put one back (the engine's checkpoints, ``checkpoint.py``, save every
problem's).

A problem that defines ``param_groups()`` gets a grouped optimizer
(``optim.grouped``) with its optimizer as the template: per-group
learning rates, momentum and schedules (``init_state``).

Under a data-parallel strategy (``EngineConfig(strategy="dp" | "zero" |
"fsdp")``, ``betty_tpu_torch/parallel``) the update runs with the engine's
mesh bound: the direct gradient and the joint ``v_by_child`` are averaged
over the ranks before they are used or accumulated, and the logged losses
are the ranks' mean. Under ``fsdp`` the state keeps only this rank's shard
of the sharded leaves of ``params``, ``grad_acc``, ``last_grad`` and
``opt_state`` (``_shard_dims``): every problem's parameters are gathered
for each update (and for ``params``, ``set_params`` and a forward outside
one, which every rank must then make), the direct gradient of a sharded
leaf is reduce-scattered to its shard, and the optimizer steps the shards. Under ``zero`` only the
optimizer state is sharded: the optimizer steps this rank's shard of the
parameters and the new parameters are all-gathered. ``full_state`` gives
the whole tensors of a state; ``state_dict`` hands them out.

Under tp, ep and pp (a mesh with a ``mdl``, ``ep`` or ``pp`` axis) the
state keeps this rank's shards over the model axis (``_shard_axis``
``"model"``), and the update computes on them: the context holds the
shards, the module computes on the ones it declares
(``FunctionalModule.local_dim``: the transformer's heads and MLP columns,
the MoE's experts, the pipelined transformer's stage of stacked blocks) and
``Problem.forward`` gathers the others where they are used, differentiably.
On two model axes (``dp x mdl x pp``) a leaf may be cut on two dims
(``parallel.Cut``): the gathers, cuts and templates go over each axis, and
the gather on use takes only the cuts the module does not compute on.
Gradients, HVPs and hypergradient vectors come out in the same layout and
are averaged over the batch ranks only; the solvers' inner products count
a shard's partial sums over the model group (``parallel.sharded_dot``,
``model_dims``); the optimizer steps the shards. ``compute_state`` is a
state in the update's layout (whole under zero/fsdp, the shards under
tp/ep). The hooks (``grad_callback``, ``param_callback``) see whole tensors
under every strategy, as in the reference: under tp/ep every problem's
parameters (and the owner's gradients) are gathered over the model group
for a hook and its edits cut back to the shards.
"""

import abc
import contextlib
from typing import Any, Callable, Dict, List, Optional
import zlib

import numpy as np
import torch

from betty_tpu_torch import parallel, utils
from betty_tpu_torch.configs import Config
from betty_tpu_torch.module import FunctionalModule, ensure_module
from betty_tpu_torch.utils import (
    clip_by_global_norm,
    fold_in,
    log_from_loss_dict,
    tree_add,
    tree_cast,
    tree_map,
    tree_zeros_like,
    value_and_grad,
)

# ---------------------------------------------------------------------------
# Context binding: maps problem name -> {"params": ..., "extra": ...} while a
# loss is evaluated. ``forward`` resolves parameters here so that
# cross-problem calls (self.outer(...)) are differentiable inputs.
# ---------------------------------------------------------------------------

_TRACE_CTX: Optional[Dict[str, Dict[str, Any]]] = None
_ACTIVE_CAPTURE: Optional[str] = None
_CAPTURED_MUTATIONS: Dict[str, Any] = {}
_TRACE_RNG: Optional[int] = None
_TRACE_RNG_CALLS: int = 0
_FORCE_FP32: bool = False
_NO_MESH = contextlib.nullcontext()  # ``Problem._scope`` of the one-process path


class force_fp32:
    """Scope that disables the reduced-precision casts of ``Problem.forward``
    (the hypergradient pipeline's ``Config.solver_precision="fp32"``).
    Parameters are fp32 masters, so the wrapped computation is exactly
    fp32."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def __enter__(self):
        global _FORCE_FP32
        self._saved = _FORCE_FP32
        if self.enabled:
            _FORCE_FP32 = True
        return self

    def __exit__(self, *exc):
        global _FORCE_FP32
        _FORCE_FP32 = self._saved
        return False


class _CtxBinding:
    def __init__(self, ctx, active: Optional[str], rng=None):
        self.ctx = ctx
        self.active = active
        self.rng = rng

    def __enter__(self):
        global _TRACE_CTX, _ACTIVE_CAPTURE, _TRACE_RNG, _TRACE_RNG_CALLS
        self._saved = (_TRACE_CTX, _ACTIVE_CAPTURE, _TRACE_RNG, _TRACE_RNG_CALLS)
        _TRACE_CTX = self.ctx
        _ACTIVE_CAPTURE = self.active
        _TRACE_RNG = self.rng
        _TRACE_RNG_CALLS = 0  # fresh read sequence per loss evaluation
        return self

    def __exit__(self, *exc):
        global _TRACE_CTX, _ACTIVE_CAPTURE, _TRACE_RNG, _TRACE_RNG_CALLS
        _TRACE_CTX, _ACTIVE_CAPTURE, _TRACE_RNG, _TRACE_RNG_CALLS = self._saved
        return False


def itd_child(problem) -> bool:
    """True for an ``IterativeProblem`` whose parents differentiate through
    its unroll (they set ``first_order=False``)."""
    return hasattr(problem, "replay_unroll") and not problem._first_order


def ctx_replace(ctx, name, params):
    """Functionally replace one problem's params in a context dict."""
    new = dict(ctx)
    entry = dict(new[name])
    entry["params"] = params
    new[name] = entry
    return new


def _collect_cross_ctx(post_ctx, base_ctx, own_name):
    """Entries a hook edited on problems other than its owner."""
    if post_ctx is None or post_ctx is base_ctx:
        return {}
    return {name: entry for name, entry in post_ctx.items()
            if name != own_name and entry is not base_ctx.get(name)}


def _rematerialized(fn):
    """``fn`` with its activations recomputed in the backward
    (``jax.checkpoint``'s counterpart). The default generators' states are
    not saved: every random draw of a loss comes from a generator seeded
    inside it (``utils.seeded_generator``), so the recompute draws the same
    values, and inside a compiled block it takes its own generators of the
    pool, reseeded alike."""
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


class _ModuleProxy:
    """``self.module`` inside ``training_step``: runs the problem's apply
    function with context-resolved parameters."""

    def __init__(self, problem: "Problem"):
        self._problem = problem

    def __call__(self, *args, **kwargs):
        return self._problem.forward(*args, **kwargs)


class Problem(abc.ABC):
    """Base class for one optimization level.

    ``module`` is a :class:`betty_tpu_torch.module.FunctionalModule` or an
    ``(apply_fn, params)`` pair; ``optimizer`` a
    :class:`betty_tpu_torch.optim.Optimizer`; ``train_data_loader`` any
    iterable of batches (a tuple of iterables for several loaders).
    """

    def __init__(self, name: str, config: Optional[Config] = None, module=None,
                 optimizer=None, scheduler: Optional[Callable] = None,
                 train_data_loader=None, extra_config=None):
        self._name = name
        self._config = config if config is not None else Config()
        self.cfg = extra_config

        self._parents: List["Problem"] = []
        self._children: List["Problem"] = []
        self._paths: List[List["Problem"]] = []

        self.train_data_loader = train_data_loader
        self.train_data_iterator = None
        self.epoch_counter = None
        self.cur_batch = None

        self._user_module = module
        self.module_fn: Optional[FunctionalModule] = None
        self.optimizer = optimizer
        self.scheduler = scheduler

        self._engine = None
        self.logger = None
        self.env = None
        self.leaf = False

        self._count = 0
        self._global_step = 0
        self.ready: List[bool] = []
        self._inner_loop_start = True
        self._training = True
        self._roll_back = False
        self._first_order = False
        self._needs_last_grad = self._config.type == "sama"

        self.precision = self._config.precision
        self.dtype = utils.get_dtype(self.precision)

        self.gas = self._config.gradient_accumulation
        self._unroll_steps = self._config.unroll_steps
        self.warmup_steps = self._config.warmup_steps
        self.gradient_clipping = self._config.gradient_clipping
        self.log_step = self._config.log_step

        self._state_cache = None
        self._trace_grads = None
        self._meta_mask = None
        self._update_fns: Dict[Any, Callable] = {}
        # state key -> tree of shard dims (None: replicated) under zero/fsdp/tp/ep,
        # over the "dp" axis (zero/fsdp) or the "model" axis (tp/ep)
        self._shard_dims: Dict[str, Any] = {}
        self._shard_axis = "dp"

        # per-problem random stream, derived stably from the name
        self._rng_seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
        self._host_rng_calls = 0
        self._host_rng_last_count = -1

    # ------------------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def config(self) -> Config:
        return self._config

    @property
    def children(self):
        return self._children

    @property
    def parents(self):
        return self._parents

    @property
    def paths(self):
        return self._paths

    @property
    def count(self) -> int:
        return self._count

    @property
    def device(self) -> torch.device:
        return self._engine.device

    @property
    def state(self) -> Dict[str, Any]:
        return self._engine.states[self._name]

    @state.setter
    def state(self, new_state):
        self._engine.states[self._name] = new_state

    @property
    def params(self):
        """Current parameters: the bound context's inside a loss evaluation,
        the engine state's otherwise (under fsdp gathered whole: a
        collective, so every rank reads them)."""
        if _TRACE_CTX is not None and self._name in _TRACE_CTX:
            return _TRACE_CTX[self._name]["params"]
        return self.full_state(self.state, ("params",))["params"]

    def set_params(self, new_params):
        """Functional parameter mutation, inside a bound context or on the
        engine state (the counterpart of reference hooks' in-place edits)."""
        global _TRACE_CTX
        if _TRACE_CTX is not None and self._name in _TRACE_CTX:
            _TRACE_CTX = ctx_replace(_TRACE_CTX, self._name, new_params)
        else:
            st = dict(self.state)
            st["params"] = self.shard_full_state(
                {"params": tree_map(torch.clone, new_params)})["params"]
            self.state = st

    @property
    def grads(self):
        """Accumulated gradients (meaningful inside ``grad_callback``)."""
        if self._trace_grads is not None:
            return self._trace_grads
        return self.state["grad_acc"]

    def set_grads_value(self, new_grads):
        self._trace_grads = new_grads

    @property
    def rng(self) -> int:
        """Per-step seed inside ``training_step``; the first read in a loss
        evaluation returns the step seed, later reads fold the read index, so
        darts' and SAMA's re-evaluations replay the same sequence. On the
        host the seed advances with the local step and a per-call counter."""
        global _TRACE_RNG_CALLS
        if _TRACE_RNG is not None:
            idx = _TRACE_RNG_CALLS
            _TRACE_RNG_CALLS = idx + 1
            return _TRACE_RNG if idx == 0 else fold_in(_TRACE_RNG, idx)
        if self._host_rng_last_count != self._count:
            self._host_rng_last_count = self._count
            self._host_rng_calls = 0
        seed = fold_in(fold_in(self._rng_seed, self._count), self._host_rng_calls)
        self._host_rng_calls += 1
        return seed

    # ------------------------------------------------------------------
    def initialize(self, engine):
        self._engine = engine
        self.ready = [False for _ in range(len(self._children))]

        first_order = [problem.config.first_order for problem in self._parents]
        self._first_order = all(first_order) if first_order else False
        if (self._parents and not self._first_order and not hasattr(self, "replay_unroll")
                and self.logger is not None):
            # second-order gradients flow only through an IterativeProblem's replay
            self.logger.warning(
                f"Problem {self._name!r}: a parent sets first_order=False "
                "but this child is not an IterativeProblem — ITD gradients "
                "through its updates are NOT computed. Use IterativeProblem "
                "for iterative differentiation, or first_order=True with an "
                "implicit solver (darts/cg/neumann/sama).")

        if self.is_implemented("configure_train_data_loader"):
            self.train_data_loader = self.configure_train_data_loader()
        if self.is_implemented("configure_module"):
            self._user_module = self.configure_module()
        if self.is_implemented("configure_optimizer"):
            self.optimizer = self.configure_optimizer()
        if self.is_implemented("configure_scheduler"):
            self.scheduler = self.configure_scheduler()

        assert self._user_module is not None, f"Problem {self._name} has no module"
        self.module_fn = ensure_module(self._user_module)

        if self.train_data_loader is not None:
            if not isinstance(self.train_data_loader, tuple):
                self.train_data_loader = (self.train_data_loader,)
            self.train_data_loader = list(self.train_data_loader)
            if engine.mesh is not None and engine.config.autoshard_data:
                self._shard_loaders(engine.mesh)
            self.train_data_iterator = [iter(dl) for dl in self.train_data_loader]
            self.epoch_counter = [0 for _ in self.train_data_loader]
            self.batches_served = [0 for _ in self.train_data_loader]
        else:
            assert type(self).get_batch is not Problem.get_batch, (
                f"Problem {self._name} requires a data loader or a get_batch override")

    def _shard_loaders(self, mesh):
        """Each rank keeps its examples ``rank::world`` of every
        ``ArrayLoader`` (``data.shard_loader``), so the global batch is the
        local batch times the ranks (``betty_tpu/problems/problem.py:382-410``).
        Other loaders cannot be cut and serve every rank the same batches:
        a loud warning. The ranks' loaders must give the same number of
        batches an epoch, or the ranks' collectives would fall out of step:
        that raises."""
        import torch.distributed as dist

        from betty_tpu_torch.data.loader import ArrayLoader, shard_loader

        self.train_data_loader = [shard_loader(dl, mesh.batch_index, mesh.batch_world)
                                  if isinstance(dl, ArrayLoader) else dl
                                  for dl in self.train_data_loader]
        unsharded = [type(dl).__name__ for dl in self.train_data_loader
                     if not isinstance(dl, ArrayLoader)]
        if unsharded and mesh.batch_world > 1:
            from betty_tpu_torch.logging import get_logger

            get_logger().warning(
                f"[Betty-Torch] problem {self._name!r}: loaders {unsharded} cannot be "
                f"auto-sharded across {mesh.batch_world} batch ranks; each will contribute an "
                "identical local batch (duplicated examples in the global batch). Shard "
                "these loaders per rank yourself, or use ArrayLoader.")
        lens = [len(dl) if hasattr(dl, "__len__") else -1 for dl in self.train_data_loader]
        # every rank sees the same max and min, so all raise or none
        both = torch.tensor(lens + [-n for n in lens], dtype=torch.float64,
                            device=self._engine.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
        if not torch.equal(both[:len(lens)], -both[len(lens):]):
            raise ValueError(f"problem {self._name!r}: the ranks' loaders give different "
                             f"numbers of batches an epoch (this rank {lens}); make the "
                             "examples divide evenly over the ranks")

    def init_state(self, rng=None) -> Dict[str, Any]:
        """Build the initial state dict of this problem on the engine's
        device."""
        variables = dict(self.module_fn.init(rng))
        params = tree_map(lambda v: v.detach().to(self.device), variables.pop("params"))
        extra = tree_map(lambda x: x.to(self.device), variables)
        if self.optimizer is not None and self.is_implemented("param_groups"):
            # per-group hyperparameters: the user's optimizer is the template
            # each group re-instantiates with its overrides
            from betty_tpu_torch import optim

            if not isinstance(self.optimizer, optim.GroupedOptimizer):
                self.optimizer = optim.grouped(self.optimizer, self.param_groups(), params)
        opt_state = self.optimizer.init(params) if self.optimizer is not None else ()
        state = {
            "params": params,
            "extra": extra,
            "opt_state": opt_state,
            "grad_acc": tree_zeros_like(params),
            "sched_step": 0,
        }
        if self._needs_last_grad:
            state["last_grad"] = tree_zeros_like(params)
        return state

    # ------------------------------------------------------------------
    @property
    def module(self):
        return _ModuleProxy(self)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """Apply this problem's module with context-resolved parameters.
        Under bf16 precision the parameters and float inputs are cast to
        bf16 copies (no autocast), unless ``force_fp32`` is active."""
        if _TRACE_CTX is not None and self._name in _TRACE_CTX:
            entry = _TRACE_CTX[self._name]
            params, extra = entry["params"], entry["extra"]
        else:
            st = self.compute_state(self.state, ("params",))
            params, extra = st["params"], st["extra"]
        params = self._gather_on_use(params)

        variables = {"params": params, **extra}
        if self.precision in ("fp16", "bf16") and not _FORCE_FP32:
            variables = tree_cast(variables, self.dtype)
            args = tuple(tree_cast(a, self.dtype) for a in args)
            kwargs = {k: tree_cast(v, self.dtype) for k, v in kwargs.items()}

        rngs = None
        if self._training:
            step_seed = _TRACE_RNG if _TRACE_RNG is not None else self.rng
            names = self.module_fn.rng_names
            rngs = {name: step_seed if i == 0 else utils.fold_rng_name(step_seed, name)
                    for i, name in enumerate(names)}
        # only the first forward of the problem's own loss keeps its mutated
        # collections (running statistics update once per step); the others
        # run in the same mode without computing them
        mutable = self.module_fn.mutable_collections if self._training else ()
        with self._scope():
            if (mutable and _ACTIVE_CAPTURE == self._name
                    and self._name not in _CAPTURED_MUTATIONS):
                out, mutated = self.module_fn.apply(variables, *args, train=self._training,
                                                    rngs=rngs, mutable=mutable, **kwargs)
                _CAPTURED_MUTATIONS[self._name] = mutated
                return out
            return self.module_fn.apply(variables, *args, train=self._training, rngs=rngs,
                                        mutable=(), **kwargs)

    @abc.abstractmethod
    def training_step(self, batch):
        """User-defined loss: a scalar or a dict with key "loss"."""
        raise NotImplementedError

    def training_step_exec(self, batch):
        return self.training_step(batch)

    def eval_loss(self, ctx, batch, rng=None, capture: bool = False):
        """Evaluate this problem's training loss on a context. Returns
        ``(loss_fp32, loss_dict, mutated_collections)``."""
        global _CAPTURED_MUTATIONS
        saved_mut = _CAPTURED_MUTATIONS
        _CAPTURED_MUTATIONS = {}
        try:
            with _CtxBinding(ctx, self._name if capture else None, rng), self._scope():
                maybe_loss_dict = self.training_step_exec(batch)
            mutated = _CAPTURED_MUTATIONS.get(self._name, None)
        finally:
            _CAPTURED_MUTATIONS = saved_mut
        is_dict = isinstance(maybe_loss_dict, dict)
        loss = maybe_loss_dict["loss"] if is_dict else maybe_loss_dict
        loss = torch.as_tensor(loss)
        if loss.dtype in (torch.bfloat16, torch.float16):
            loss = loss.float()  # bf16 compute, fp32 loss
        loss_dict = {"loss": loss}
        if is_dict:
            for key, value in maybe_loss_dict.items():
                if key != "loss":
                    loss_dict[key] = value
        return loss, loss_dict, mutated

    # ------------------------------------------------------------------
    # data-parallel layout
    # ------------------------------------------------------------------
    def _mesh(self):
        return None if self._engine is None else self._engine.mesh

    def _scope(self):
        """The scope that binds the mesh for the collectives
        (``parallel.active``); a shared no-op without a mesh."""
        mesh = self._mesh()
        return _NO_MESH if mesh is None else parallel.active(mesh)

    def full_state(self, state=None, keys=None):
        """``state`` (default this problem's) with the whole tensors of its
        shards (``keys``: only those state keys). A collective under
        zero/fsdp/tp/ep: every rank calls it."""
        state = self.state if state is None else state
        if not self._shard_dims:
            return state
        out = dict(state)
        for k, dims in self._shard_dims.items():
            if k in out and (keys is None or k in keys):
                out[k] = parallel.gather_shards(out[k], dims, self._mesh(), self._shard_axis)
        return out

    def shard_full_state(self, state):
        """A whole-tensor ``state`` cut to this rank's shards (no
        communication): the inverse of ``full_state``."""
        if not self._shard_dims:
            return state
        out = dict(state)
        for k, dims in self._shard_dims.items():
            if k in out:
                out[k] = parallel.mesh.shard_tree(out[k], dims, self._mesh(), self._shard_axis)
        return out

    def full_state_like(self, state):
        """Templates of the whole tensors of a sharded ``state`` (empty
        tensors; no communication)."""
        if not self._shard_dims:
            return state
        out = dict(state)
        for k, dims in self._shard_dims.items():
            if k in out:
                out[k] = parallel.mesh.full_shape_like(out[k], dims, self._mesh(),
                                                       self._shard_axis)
        return out

    def _model_sharded(self) -> bool:
        return self._shard_axis == "model" and bool(self._shard_dims)

    def compute_state(self, state=None, keys=None):
        """``state`` in the layout the update computes on: whole tensors
        under zero/fsdp (``full_state``), this rank's shards under tp/ep."""
        if self._model_sharded():
            return self.state if state is None else state
        return self.full_state(state, keys)

    def model_dims(self):
        """The parameters' shard dims over the model axis (tp/ep), or None:
        what ``parallel.sharded_dot`` needs for a vector over them."""
        return self._shard_dims.get("params") if self._model_sharded() else None

    def _gather_on_use(self, params):
        """Under tp/ep, the whole tensors of the sharded parameters the
        module does not compute on as shards (``FunctionalModule.local_dim``),
        gathered over the model group, differentiably; the rest as given."""
        dims = self.model_dims()
        if not dims:
            return params
        mesh = self._mesh()
        if not mesh.composed:
            local = self.module_fn.local_dim
            gather = utils.tree_map_named(
                lambda name, d: None if d is None or local(name) == d else d, dims)
            return parallel.gather_shards(params, gather, mesh, "model")

        def rest(name, d):
            # two model axes: gather the cuts the module does not take as
            # they are (an int local dim is a tp dim, over mdl or ep)
            local = self.module_fn.local_dim(name)
            pairs = parallel.mesh.cut_pairs(local, parallel.mesh.tp_view(mesh) or mesh)
            left = tuple(p for p in parallel.mesh.cut_pairs(d, mesh) if p not in pairs)
            return parallel.mesh.Cut(left) if left else None

        gather = utils.tree_map_named(rest, dims)
        return parallel.gather_shards(params, gather, mesh, "model")

    def _param_shard_dims(self):
        """The parameters' shard dims where the optimizer steps shards:
        fsdp's (the state holds shards) or, under zero, the rule applied to
        the parameters (the optimizer state's shards)."""
        if "params" in self._shard_dims:
            return self._shard_dims["params"]
        if "opt_state" in self._shard_dims:
            return parallel.fsdp_shardings(self.state["params"], self._mesh(),
                                           min_size=parallel.mesh.FSDP_MIN_SIZE)
        return None

    def _reduce_direct(self, dgrad, v_by_child, loss_dict):
        """The direct gradient, the joint child vectors and the logged
        losses averaged over the ranks; under fsdp the sharded leaves of
        the gradient reduce-scattered to this rank's shards."""
        mesh = self._mesh()
        dims = self._shard_dims.get("params") if self._shard_axis == "dp" else None
        if dims:
            dgrad = parallel.reduce_scatter_mean(dgrad, dims, mesh)
            v_by_child, loss_dict = parallel.grad_mean((v_by_child, loss_dict), mesh)
        else:
            dgrad, v_by_child, loss_dict = parallel.grad_mean((dgrad, v_by_child, loss_dict),
                                                              mesh)
        return dgrad, v_by_child, loss_dict

    def is_rank_zero(self) -> bool:
        """Rank 0 of the process group (``betty_tpu/problems/problem.py:1078``)."""
        return parallel.is_rank_zero()

    # ------------------------------------------------------------------
    def set_meta_mask(self, mask):
        """Restrict which parameters take part in hypergradients (a bool tree
        matching ``params``)."""
        self._meta_mask = mask

    def meta_filter_grad(self, grad):
        if self._meta_mask is None:
            return grad
        return tree_map(lambda m, g: torch.where(torch.as_tensor(m), g, torch.zeros_like(g)),
                        self._meta_mask, grad)

    # ------------------------------------------------------------------
    def build_update_fn(self, apply_update: bool, advance_sched: bool = True) -> Callable:
        """The per-step update: direct gradient + hypergradient paths + (at an
        accumulation boundary) the optimizer step. ``path_batches`` maps each
        intermediate problem on this problem's paths to its current batch."""
        from betty_tpu_torch.hypergradient import compute_path_grads

        problem = self
        # ITD children: the parent's gradient flows through their unrolled
        # updates by a differentiable replay (problems/iterative.py)
        itd_children = [c for c in self._children if itd_child(c)]
        itd_names = {c.name for c in itd_children}
        # one backward pass serves the direct gradient and every path's
        # starting vector v = d(loss)/d(child params), unless a precision
        # split (bf16 step, fp32 solver) needs a separate fp32 evaluation
        has_paths = problem._config.first_order and len(problem._paths) > 0
        path_children = {}
        if has_paths:
            for path in problem._paths:
                path_children[path[1].name] = path[1]
        reduced_precision = problem.precision in ("fp16", "bf16") or any(
            ch.precision in ("fp16", "bf16") for ch in path_children.values())
        joint_v = (has_paths
                   and not (reduced_precision and problem._config.solver_precision == "fp32")
                   # a replay would shadow the child-params substitution
                   and not (set(path_children) & itd_names))

        def update(states, batch, path_batches, itd_data, rng):
            with problem._scope():
                return _update(states, batch, path_batches, itd_data, rng)

        def _update(states, batch, path_batches, itd_data, rng):
            mesh = problem._mesh()
            ctx = {name: {"params": s["params"], "extra": s["extra"]}
                   for name, s in states.items()}
            if mesh is not None:  # fsdp: every problem's parameters whole for the update
                for p in problem._engine.problems:
                    if p.name in ctx:
                        ctx[p.name]["params"] = p.compute_state(states[p.name],
                                                                ("params",))["params"]
            gas = float(problem.gas)

            def direct_loss(own_params, child_params):
                c = ctx_replace(ctx, problem._name, own_params)
                for name, cp in child_params.items():
                    c = ctx_replace(c, name, cp)
                for ch in itd_children:
                    c = ctx_replace(c, ch.name, ch.replay_unroll(c, itd_data[ch.name], rng))
                loss, loss_dict, mutated = problem.eval_loss(c, batch, rng=rng, capture=True)
                return loss / gas, (loss_dict, mutated)

            if problem._config.remat:
                direct_loss = _rematerialized(direct_loss)

            child_args = ({name: ctx[name]["params"] for name in path_children}
                          if joint_v else {})
            (_, (loss_dict, mutated)), grad_out = value_and_grad(
                direct_loss, ctx[problem._name]["params"], child_args,
                argnums=(0, 1) if joint_v else 0, has_aux=True)
            if joint_v:
                dgrad, v_by_child = grad_out
            else:
                dgrad, v_by_child = grad_out, None
            if mesh is not None:
                dgrad, v_by_child, loss_dict = problem._reduce_direct(dgrad, v_by_child,
                                                                      loss_dict)

            grads = dgrad
            if has_paths:
                hyper = compute_path_grads(problem, ctx, states, batch, path_batches, rng,
                                           gas, v_by_child=v_by_child)
                if "params" in problem._shard_dims and problem._shard_axis == "dp":
                    hyper = parallel.mesh.shard_tree(hyper, problem._shard_dims["params"], mesh)
                grads = tree_add(grads, hyper)

            state = dict(states[problem._name])
            state["grad_acc"] = tree_add(state["grad_acc"], grads)
            if mutated:
                if problem.precision in ("fp16", "bf16"):
                    mutated = tree_cast(mutated, torch.float32)
                state["extra"] = {**state["extra"], **mutated}

            cross_updates = {}
            if problem.is_implemented("grad_callback"):
                # the hook sees whole tensors, cut back to the shards after
                whole = problem.full_state(state, ("params", "grad_acc"))
                problem._trace_grads = whole["grad_acc"]
                hook_ctx = problem._whole_ctx(ctx)
                hook_ctx[problem._name] = {"params": whole["params"], "extra": state["extra"]}
                with _CtxBinding(hook_ctx, None, rng):
                    problem.grad_callback()
                    cross_updates.update(problem._cut_cross(
                        _collect_cross_ctx(_TRACE_CTX, hook_ctx, problem._name)))
                state["grad_acc"] = problem.shard_full_state(
                    {"grad_acc": problem._trace_grads})["grad_acc"]
                problem._trace_grads = None

            if apply_update:
                state, cross = problem._apply_optimizer(state, ctx, rng)
                cross_updates.update(cross)

            # with roll_back the scheduler is not stepped during the unroll,
            # only once per roll-back re-step
            if advance_sched:
                state["sched_step"] = state["sched_step"] + 1

            new_states = dict(states)
            for name, entry in cross_updates.items():
                ns = dict(new_states[name])
                ns["params"] = entry["params"]
                ns["extra"] = entry["extra"]
                new_states[name] = ns
            new_states[problem._name] = state
            return new_states, loss_dict

        return update

    def _apply_optimizer(self, state, ctx, rng, sharded: bool = True):
        """Optimizer step at a gradient-accumulation boundary. Returns
        ``(new_state, cross_updates)``; ``cross_updates`` carries params/extra
        that ``param_callback`` set on other problems. ``sharded``: ``state``
        is in the engine's layout (under zero/fsdp the optimizer steps this
        rank's shards); False for a state of whole tensors (an ITD
        replay)."""
        global _TRACE_CTX
        grads = state["grad_acc"]
        cross_updates = {}
        dims = self._shard_dims if sharded else {}
        mesh = self._mesh()
        pdims = dims.get("params")
        axis = self._shard_axis
        if self.gradient_clipping > 0.0:
            # the global norm of the whole gradient, as in dp
            whole = parallel.gather_shards(grads, pdims, mesh, axis) if pdims else grads
            grads = clip_by_global_norm(whole, self.gradient_clipping)
            if pdims:
                grads = parallel.mesh.shard_tree(grads, pdims, mesh, axis)

        if self.is_implemented("custom_optimizer_step"):
            whole = self.full_state({**state, "grad_acc": grads}) if dims else \
                {**state, "grad_acc": grads}
            new_params = self.custom_optimizer_step(whole["params"], whole["grad_acc"], whole)
            if pdims:
                new_params = parallel.mesh.shard_tree(new_params, pdims, mesh, axis)
            new_opt_state = state["opt_state"]
        elif "opt_state" in dims and not pdims:
            # zero: step this rank's shard of the parameters, gather the result
            udims = self._param_shard_dims()
            p_shard = parallel.mesh.shard_tree(state["params"], udims, mesh)
            g_shard = parallel.mesh.shard_tree(grads, udims, mesh)
            updates, new_opt_state = self.optimizer.update(
                g_shard, state["opt_state"], p_shard, sched_step=state["sched_step"])
            new_params = parallel.gather_shards(tree_map(torch.add, p_shard, updates), udims,
                                                mesh)
        else:
            updates, new_opt_state = self.optimizer.update(
                grads, state["opt_state"], state["params"], sched_step=state["sched_step"])
            new_params = tree_map(torch.add, state["params"], updates)

        state = dict(state)
        state["params"] = new_params
        state["opt_state"] = new_opt_state
        if self._needs_last_grad:
            state["last_grad"] = grads  # SAMA reads the gradient of this step

        if self.is_implemented("param_callback"):
            base = {k: dict(v) for k, v in (self._whole_ctx(ctx) if sharded else ctx).items()}
            # the hook sees whole tensors, cut back to the shards after
            whole = parallel.gather_shards(state["params"], pdims, mesh, axis) if pdims else \
                state["params"]
            base[self._name] = {"params": whole, "extra": state["extra"]}
            with _CtxBinding(base, None, rng):
                self.param_callback()
                new_params = _TRACE_CTX[self._name]["params"]
                state["params"] = (parallel.mesh.shard_tree(new_params, pdims, mesh, axis)
                                   if pdims else new_params)
                state["extra"] = _TRACE_CTX[self._name]["extra"]
                cross = _collect_cross_ctx(_TRACE_CTX, base, self._name)
                cross_updates.update(self._cut_cross(cross) if sharded else cross)

        state["grad_acc"] = tree_zeros_like(state["grad_acc"])
        return state, cross_updates

    def _whole_ctx(self, ctx):
        """A copy of the update's context with the tp/ep problems' parameters
        gathered whole over the model group, as a hook sees them (a
        collective: every rank calls its hooks)."""
        ctx = dict(ctx)
        if self._mesh() is not None:
            for p in self._engine.problems:
                if p._model_sharded() and p.name in ctx:
                    ctx[p.name] = {**ctx[p.name],
                                   "params": p.full_state(ctx[p.name], ("params",))["params"]}
        return ctx

    def _cut_cross(self, cross):
        """Cross-problem edits of a hook (whole parameters) cut to each
        problem's layout."""
        if self._mesh() is None:
            return cross
        problems = {p.name: p for p in self._engine.problems}
        out = {}
        for name, entry in cross.items():
            entry = dict(entry)
            if name in problems:
                entry["params"] = problems[name].shard_full_state(
                    {"params": entry["params"]})["params"]
            out[name] = entry
        return out

    def _get_update_fn(self, apply_update: bool, advance_sched: bool = True) -> Callable:
        key = (bool(apply_update), bool(advance_sched))
        if key not in self._update_fns:
            self._update_fns[key] = self.build_update_fn(apply_update=key[0],
                                                         advance_sched=key[1])
        return self._update_fns[key]

    # ------------------------------------------------------------------
    def one_step_descent(self, batch=None, advance_sched=None):
        if batch is None:
            self.cur_batch = self.get_batch()
            batch = self.cur_batch
        if advance_sched is None:
            advance_sched = not self._roll_back

        apply_update = self._count % self.gas == 0
        path_batches = {p.name: p.cur_batch for p in self._path_intermediates()}
        itd_data = {c.name: c.get_unroll_data() for c in self._children if itd_child(c)}
        rng = fold_in(self._rng_seed, self._count)
        update_fn = self._get_update_fn(apply_update, advance_sched)
        new_states, loss_dict = update_fn(self._engine.states, batch, path_batches, itd_data,
                                          rng)
        self._engine.states = new_states
        return loss_dict

    def _path_intermediates(self):
        seen = {}
        for path in self._paths:
            for q in path[1:-1]:
                seen[q.name] = q
        return list(seen.values())

    # ------------------------------------------------------------------
    # step recursion (reference problem.py:371-454)
    # ------------------------------------------------------------------
    def step_normal(self, global_step=None):
        if self.check_ready():
            if self._inner_loop_start:
                if self.is_implemented("on_inner_loop_start"):
                    self.on_inner_loop_start()
                self._inner_loop_start = False
                if self._roll_back:
                    self.cache_states()

            if self._training:
                self._count += 1

            loss_dict = self.one_step_descent()

            if self.log_step > 0 and self._count % self.log_step == 0:
                self.log(loss_dict, global_step)

            if (self._training
                    and self._count % (self._unroll_steps * self.gas) == 0
                    and self._count > self.warmup_steps):
                for problem in self._parents:
                    idx = problem.children.index(self)
                    problem.ready[idx] = True
                    problem.step_normal(global_step=global_step)
                self._inner_loop_start = True

            self.ready = [False for _ in range(len(self._children))]

    def step_after_roll_back(self):
        if self.check_ready() and self._training:
            if self._roll_back:
                self.recover_states()
                _ = self.one_step_descent(batch=self.cur_batch, advance_sched=True)
                for problem in self._parents:
                    idx = problem.children.index(self)
                    problem.ready[idx] = True
                    problem.step_after_roll_back()
            self.ready = [False for _ in range(len(self._children))]

    def step(self, global_step=None):
        self._global_step = global_step
        self.step_normal(global_step=global_step)
        if (self._count % (self._unroll_steps * self.gas) == 0
                and self._count > self.warmup_steps):
            self.step_after_roll_back()

    # ------------------------------------------------------------------
    def get_batch(self):
        batch = tuple(self.get_batch_single_loader(i)
                      for i in range(len(self.train_data_loader)))
        return batch[0] if len(batch) == 1 else batch

    def get_batch_single_loader(self, idx):
        data_iterator = self.train_data_iterator[idx]
        try:
            batch = next(data_iterator)
            self.batches_served[idx] += 1
        except StopIteration:
            if idx == 0:
                self.epoch_callback_exec()
            self.epoch_counter[idx] += 1
            train_data_loader = self.train_data_loader[idx]
            if hasattr(train_data_loader, "set_epoch"):
                train_data_loader.set_epoch(self.epoch_counter[idx])
            self.train_data_iterator[idx] = iter(train_data_loader)
            batch = next(self.train_data_iterator[idx])
            self.batches_served[idx] = 1
        return self._convert_batch(batch)

    def _convert_batch(self, batch):
        device = self.device

        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, (np.ndarray, np.generic)):
                return torch.from_numpy(np.asarray(x)).to(device)
            return x

        converted = tree_map(put, batch)
        if isinstance(converted, list):
            return tuple(converted)
        return converted

    def epoch_callback_exec(self):
        if self.is_implemented("epoch_callback"):
            self.epoch_callback()

    # roll-back cache: states are never updated in place, so a reference
    # to the old state dict is the cache
    def cache_states(self):
        self._state_cache = self.state

    def recover_states(self):
        if self._state_cache is None:
            return
        self.state = self._state_cache
        self._state_cache = None

    # ------------------------------------------------------------------
    def check_ready(self) -> bool:
        return all(self.ready)

    def gradient_accumulation_boundary(self) -> bool:
        return bool(self._count % self.gas == 0)

    def state_dict(self) -> Dict[str, Any]:
        """This problem's whole state as host tensors (copies; under
        zero/fsdp the whole tensors of the shards, a collective); integer
        leaves (Adam's ``count``, ``sched_step``) stay integers."""
        from betty_tpu_torch.checkpoint import to_host

        return to_host(self.full_state())

    def load_state_dict(self, state_dict):
        """Put a state from :meth:`state_dict` back, each tensor on the
        device and in the dtype of the one it replaces. A state of another
        structure or shape raises ``ValueError`` naming both."""
        from betty_tpu_torch.checkpoint import restore_like

        self.state = self.shard_full_state(restore_like(
            self.full_state_like(self.state), state_dict,
            f"load_state_dict for problem {self._name!r}"))

    def log(self, stats, global_step):
        loss_log = log_from_loss_dict(stats)
        if self.logger is not None:
            self.logger.info(f'[Problem "{self._name}"] [Global Step {global_step}] '
                             f"[Local Step {self._count}] {loss_log}")
            cur_step = self._count if self._config.log_local_step else global_step
            self.logger.log(stats, tag=self._name, step=cur_step)

    def add_child(self, problem: "Problem"):
        assert problem is not self
        self._children.append(problem)

    def add_parent(self, problem: "Problem"):
        assert problem is not self
        self._parents.append(problem)

    def add_paths(self, paths):
        self._paths.extend(paths)

    def add_logger(self, logger):
        self.logger = logger

    def add_env(self, env):
        self.env = env

    def clear_dependencies(self):
        self._children = []
        self._parents = []
        self._paths = []
        self._update_fns = {}

    def is_implemented(self, fn_name: str) -> bool:
        return callable(getattr(self, fn_name, None))

    def train(self):
        self._training = True

    def eval(self):
        self._training = False

    def parameters(self):
        return self.params

    def trainable_parameters(self):
        return self.params

    def meta_trainable_parameters(self):
        if self._meta_mask is None:
            return self.params
        return self.meta_filter_grad(self.params)
