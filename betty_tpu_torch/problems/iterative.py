"""IterativeProblem: iterative differentiation (ITD, MAML-style).

Counterpart of ``betty_tpu/problems/iterative.py``. While it runs its
unroll eagerly, the problem records the state it started from and the
batches it consumed. When a parent with ``Config(first_order=False)``
computes its gradient, the child's post-unroll parameters are replayed as a
differentiable function of the parent's context (``replay_unroll``): each
micro-step's gradient is taken with ``create_graph=True``
(``utils.value_and_grad``) and the functional optimizer's update is built
from it out of place, so the parent's backward runs through every inner
step, the second derivatives included. The replay recomputes the unroll's
forwards rather than keeping the eager steps' graphs.

The replay is a Python loop over the recorded optimizer steps (JAX's
``lax.scan``); the batches are passed as a tuple, one per micro-step, not
stacked, so there is no stacked-batch cache to keep in step with the
recording. It repeats the eager trajectory: per-micro-step seeds
(``start_count + k * gas + j + 1``, the count the eager step folded), the
``gas`` micro-steps of each optimizer step, BatchNorm statistics threaded
from each micro-step into the next (``capture=True``), ``grad_callback`` on
the running sum, and the optimizer step of ``_apply_optimizer`` (clipping,
``custom_optimizer_step``, ``param_callback``, ``last_grad``), with the
scheduler frozen during a ``roll_back`` unroll as the eager steps freeze it.

The replay computes in the layout of the eager update (``compute_state``).
Each micro-step's gradient goes through the differentiable all-reduce over
the batch ranks (``parallel.all_reduce_tree``), whose backward is itself an
all-reduce; with the mean over the ranks of the parent's gradient that
gives the gradient of the global objective. Under zero/fsdp the replay
starts from the whole tensors of the recorded state and steps whole
tensors. Under tp, ep, pp and sp with model-sharded leaves, and on two to
four model axes, it starts from this rank's shards of the recorded state (no
gather), hands them to the loss as the eager step does (``Problem.forward``
gathers or cuts on use, differentiably), keeps each gradient in the
shards' layout, steps the shards (``_apply_optimizer``: the clipping norm
from the shards, ``parallel.clip_by_sharded_norm``; the hooks on whole
tensors gathered differentiably and cut back through *f*) and returns the
shards. Every collective on that path (*f*, *g*, the gathers and cuts, the
ring shifts, the sequence gathers) has a backward made of collectives, so
the parent's backward, which runs through the replay's
``create_graph=True`` gradients, is a double backward through them, made
by every rank in one order.

MAML-style meta-initialization: override ``unroll_init(self, start_params)``
to return the initial inner parameters as a function of other problems'
parameters in the bound context (e.g. ``return self.outer.params``), so
the gradient reaches the meta-initialization.

An engine checkpoint taken mid-unroll saves the recorded start state and
batches (``checkpoint.py``); the restore puts them back with
``_pending_unroll_reset`` off, so the parent's replay in the resumed run
is the uninterrupted run's.

Note: differentiating through Adam at zero second moment gives NaN (the
derivative of sqrt at 0); use SGD inner optimizers, as is standard for
MAML.
"""

from typing import Any, Dict, List, Optional

from betty_tpu_torch import parallel
from betty_tpu_torch.problems.problem import Problem, _CtxBinding
from betty_tpu_torch.utils import StepSeed, tree_add, tree_map, tree_zeros_like, value_and_grad


def unroll_data(start, start_count, batches):
    """What ``replay_unroll`` reads: the state the unroll started from, the
    count before its first micro-step and its batches in order."""
    return {"start_params": start["params"], "start_opt_state": start["opt_state"],
            "start_sched_step": start["sched_step"], "start_extra": start["extra"],
            "start_count": start_count, "batches": tuple(batches)}


class IterativeProblem(Problem):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._unroll_batches: List[Any] = []
        self._unroll_start_state: Optional[Dict[str, Any]] = None
        self._pending_unroll_reset = False
        self._in_rollback_restep = False

    # -- unroll bookkeeping ------------------------------------------------
    def step_normal(self, global_step=None):
        if self.check_ready() and self._inner_loop_start:
            # record the starting point after on_inner_loop_start runs (the
            # hook may reset the parameters)
            self._pending_unroll_reset = True
        super().step_normal(global_step=global_step)

    def step_after_roll_back(self):
        # the roll-back re-step is a descent outside the counted unroll: the
        # next window's replay starts from the state after it, so its batch
        # is not recorded in the window just consumed
        self._in_rollback_restep = True
        try:
            super().step_after_roll_back()
        finally:
            self._in_rollback_restep = False

    def one_step_descent(self, batch=None, advance_sched=None):
        if self._pending_unroll_reset:
            # states are never updated in place: a reference is the record
            self._unroll_start_state = self.state
            self._unroll_batches = []
            self._pending_unroll_reset = False
        loss_dict = super().one_step_descent(batch=batch, advance_sched=advance_sched)
        if not self._in_rollback_restep:
            self._unroll_batches.append(self.cur_batch)
        return loss_dict

    # -- differentiable replay -----------------------------------------------
    def get_unroll_data(self):
        """The recorded unroll, passed to a parent's update as its
        ``itd_data`` entry: the start state, the count before the window's
        first micro-step and the batches."""
        assert self._unroll_start_state is not None and self._unroll_batches, (
            f"IterativeProblem {self.name} has no recorded unroll to replay")
        # the eager step folds its seed from the count after the increment:
        # micro-step m of the window used start_count + m + 1
        return unroll_data(self._unroll_start_state,
                           self._count - len(self._unroll_batches), self._unroll_batches)

    def unroll_init(self, start_params):
        """Initial inner parameters of the replay. Default: the recorded
        start parameters (constants for the parent). Override to couple them
        to other problems' parameters, e.g. ``return self.outer.params``."""
        return start_params

    def replay_unroll(self, ctx, data, rng=None):
        """This problem's last unroll again, as a differentiable function of
        the context ``ctx``; returns the post-unroll parameters in the
        update's layout (``compute_state``: this rank's shards under the
        model-parallel strategies). ``data`` comes from
        :meth:`get_unroll_data` (or a compiled block's record of the
        same)."""
        sharded = self._model_sharded()
        start = self.compute_state({"params": data["start_params"],
                                    "opt_state": data["start_opt_state"]})
        with _CtxBinding(ctx, None, rng):
            init_params = self._in_layout(self.unroll_init(start["params"]), start["params"])

        batches = data["batches"]
        gas = self.gas
        if len(batches) % gas:
            raise ValueError(f"IterativeProblem {self.name}: {len(batches)} recorded batches "
                             f"do not group into optimizer steps of {gas}")
        # the eager steps freeze the scheduler during a roll_back unroll
        advance = not self._roll_back
        start_count = data.get("start_count")
        problem = self

        state = {
            "params": init_params,
            "extra": data.get("start_extra", ctx[self.name]["extra"]),
            "opt_state": start["opt_state"],
            "sched_step": data["start_sched_step"],
            "grad_acc": tree_zeros_like(init_params),
        }
        if self._needs_last_grad:
            state["last_grad"] = tree_zeros_like(init_params)

        for k in range(len(batches) // gas):
            grad_acc = tree_zeros_like(state["params"])
            extra = state["extra"]
            for j in range(gas):
                micro = batches[k * gas + j]
                r = rng
                if start_count is not None:
                    r = StepSeed.make(self._rng_seed, start_count + k * gas + j + 1)

                def loss_fn(p, _extra=extra, _micro=micro, _r=r):
                    c = dict(ctx)
                    c[problem.name] = {"params": p, "extra": _extra}
                    loss, _, mutated = problem.eval_loss(c, _micro, rng=_r, capture=True)
                    return loss / gas, mutated

                (_, mutated), g = value_and_grad(loss_fn, state["params"], argnums=0,
                                                 has_aux=True, create_graph=True)
                # in the parameters' layout, averaged over the batch ranks
                grad_acc = tree_add(grad_acc, parallel.all_reduce_tree(g, "mean"))
                if mutated:
                    extra = {**extra, **mutated}
                if self.is_implemented("grad_callback"):
                    grad_acc = self._replay_grad_callback(ctx, state["params"], grad_acc,
                                                          extra, r, sharded)

            step_state = dict(state)
            step_state["extra"] = extra
            step_state["grad_acc"] = grad_acc
            if advance and gas > 1:
                # the eager steps advance the scheduler every micro-step, so
                # the optimizer step sees start + gas - 1
                step_state["sched_step"] = step_state["sched_step"] + (gas - 1)
            c = dict(ctx)
            c[self.name] = {"params": state["params"], "extra": extra}
            # cross-problem edits of param_callback apply on the eager path
            # only: the replay returns this problem's parameters
            step_state, _ = self._apply_optimizer(step_state, c, rng, sharded=sharded)
            if advance:
                step_state["sched_step"] = step_state["sched_step"] + 1
            state = step_state
        return state["params"]

    def _in_layout(self, params, start_params):
        """``unroll_init``'s parameters in the replay's layout: under the
        model-parallel strategies a leaf at the whole shape of a sharded
        one (another problem's parameters, held whole) is cut to this
        rank's shard through *f* (``parallel.cut_whole``), so the gradient
        reaches every rank's part of it."""
        if params is start_params or not self._model_sharded():
            return params
        dims = tree_map(lambda x, s, d: None if tuple(x.shape) == tuple(s.shape) else d,
                        params, start_params, self._shard_dims["params"])
        return parallel.cut_whole(params, dims, self._mesh())

    def _replay_grad_callback(self, ctx, params, grad_acc, extra, rng, sharded):
        """``grad_callback`` on the replay's running sum, as the eager step
        calls it: on whole tensors, gathered differentiably under the
        model-parallel strategies and cut back through *f*, so its edits
        flow through the replay."""
        cc = dict(ctx)
        if sharded:
            cc = self._whole_ctx({name: e for name, e in ctx.items() if name != self.name})
            whole = self.full_state({"params": params, "grad_acc": grad_acc})
            params, grad_acc = whole["params"], whole["grad_acc"]
        self._trace_grads = grad_acc
        cc[self.name] = {"params": params, "extra": extra}
        with _CtxBinding(cc, None, rng):
            self.grad_callback()
        grad_acc, self._trace_grads = self._trace_grads, None
        return self._cut_model(grad_acc) if sharded else grad_acc
