"""Engine: dependency-graph parsing and the training-loop driver.

Counterpart of ``betty_tpu/engine.py``. The graph mechanics
(``find_paths`` DFS, leaf detection, name-attribute injection, the step
recursion driven from the leaves) keep the reference's semantics;
``configure_systems`` only chooses the device: ``"cuda"`` unless the caller
passes another. States live in ``engine.states`` (name -> state dict).
``EngineConfig(compile_blocks=True)`` runs the steady schedule as compiled
blocks (``run_compiled``, ``betty_tpu_torch/compile.py``): on CUDA one
graph replay a meta-period. ``EngineConfig(profile_dir=...)`` records the
training loop under ``torch.profiler`` (the host's ops, and the card's
kernels on CUDA) and writes its trace there as
``<host>_<pid>.<ns>.pt.trace.json``, over the span JAX's
``start_trace``/``stop_trace`` cover: the driver loop, or the whole of
``run_compiled`` after its schedule probe (warm-up, capture and replays).
An engine that overrides ``train_step`` (iMAML's, which steps its env
there) runs in driver mode under ``compile_blocks``: a block would replay
the problems' steps without calling it.

Engine checkpoints (``betty_tpu_torch/checkpoint.py``): ``save_checkpoint``
/ ``load_checkpoint``; ``EngineConfig(checkpoint_step=N, checkpoint_dir=...)``
saves every N global steps from ``maybe_validate_checkpoint``, the one
hook of both loops (eval, validation, log, train, early stop, checkpoint);
``EngineConfig(auto_resume=True)`` starts ``run()`` from the checkpoint in
``checkpoint_dir`` when there is one, ``train_iters`` being the run's total.
A resumed run equals the uninterrupted one bit for bit, in driver mode and
compiled (a block never spans two checkpoint boundaries, and a save between
blocks reads the runner's live state).

``EngineConfig(strategy="dp" | "distributed" | "zero" | "fsdp")`` runs one
process a rank (``betty_tpu/engine.py:78-166``): ``configure_systems``
joins the process group (``parallel.maybe_init_distributed``: torchrun's
or the ``BETTY_*`` variables, else a world of one) and builds the mesh of
``mesh_shape``; ``initialize`` places each problem's state for the strategy
(``parallel.shard_state``; the shard dims kept as ``problem._shard_dims``),
and each problem's ``ArrayLoader``s give each rank its examples
(``Problem.initialize``). The run reaches the parameters of the
one-process run on the union of the ranks' batches. Only rank 0 logs;
validation runs on every rank and its numbers are averaged over the ranks,
so the early-stopping decision agrees. A strategy other than ``"default"``
with a ``mesh_shape`` of ``None`` puts every rank on ``dp``; ``"default"``
with a ``mesh_shape`` runs as ``"dp"``.
"""

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from betty_tpu_torch import parallel
from betty_tpu_torch.configs import EngineConfig
from betty_tpu_torch.logging import logger
from betty_tpu_torch.logging.logger_base import LoggerBase
from betty_tpu_torch.misc.early_stopping import EarlyStopping
from betty_tpu_torch.utils import log_from_loss_dict, require_device, tree_leaves


class Engine:
    def __init__(self, problems, config=None, dependencies=None, env=None, device=None):
        self.config = config if config is not None else EngineConfig()

        self.train_iters = 0
        self.valid_step = 0
        self.global_step = 0

        self.logger_type = None
        self.logger = None

        self.problems = problems
        self.leaves: List = []
        self.dependencies = dependencies
        self.env = env
        self.device = torch.device(device if device is not None else "cuda")

        self.early_stopping: Optional[EarlyStopping] = None
        self._roll_back = False

        self.states: Dict[str, dict] = {}
        self.block_runner = None
        self.mesh: Optional[parallel.Mesh] = None
        self.strategy = "default"

        self.initialize()

    def parse_config(self):
        self.train_iters = self.config.train_iters
        self.valid_step = self.config.valid_step
        self.logger_type = self.config.logger_type
        self._roll_back = self.config.roll_back
        if self.config.early_stopping:
            self.early_stopping = EarlyStopping(
                metric=self.config.early_stopping_metric,
                mode=self.config.early_stopping_mode,
                tolerance=self.config.early_stopping_tolerance,
            )

    def configure_systems(self):
        """The device (a CUDA device must exist: no fallback to the CPU) and,
        under a data-parallel strategy, the process group and the mesh."""
        require_device(self.device, "Engine")
        strategy = self.config.strategy
        if strategy == "default" and self.config.mesh_shape is None:
            return
        self.strategy = "dp" if strategy in ("default", "distributed") else strategy
        parallel.maybe_init_distributed(self.device)
        self.mesh = parallel.make_mesh(self.config.mesh_shape)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def is_rank_zero(self) -> bool:
        return parallel.is_rank_zero()

    def initialize(self):
        self.parse_config()
        self.configure_systems()

        self.logger = logger(logger_type=self.logger_type) if self.is_rank_zero() else \
            _RankLogger()
        self.logger.info("Initializing Multilevel Optimization...")
        start = time.time()

        self.parse_dependency()
        for problem in self.problems:
            self.set_problem_attr(problem)

        if self.env is not None:
            self.env.engine = self
            self.env.configure_device(self.device)
            self.env.initialize()

        for i, problem in enumerate(self.problems):
            problem.add_logger(self.logger)
            if len(problem.parents) > 0:
                problem._roll_back = self._roll_back
            if self.env is not None:
                problem.add_env(self.env)
            problem.initialize(self)
            state = problem.init_state(i)
            if self.mesh is not None:
                _check_on_card(problem.name, state, self.device)
                problem._shard_dims = parallel.state_shard_dims(state, self.mesh, self.strategy)
                state = parallel.shard_state(state, self.mesh, self.strategy)
            self.states[problem.name] = state

        self.logger.info(f"Time spent on initialization: {time.time() - start:.3f} (s)")

    # ------------------------------------------------------------------
    # graph parsing (reference engine.py:217-290)
    # ------------------------------------------------------------------
    def check_leaf(self, problem) -> bool:
        for _, value_list in self.dependencies["l2u"].items():
            if problem in set(value_list):
                return False
        return True

    def find_paths(self, src, dst):
        results = []
        path = [src]
        self.dfs(src, dst, path, results)
        assert len(results) > 0, f"No path from {src.name} to {dst.name}!"
        for i, _ in enumerate(results):
            results[i].reverse()
            results[i].append(dst)
        return results

    def dfs(self, src, dst, path, results):
        if src is dst:
            assert len(path) > 1
            results.append(list(path))
        elif src not in self.dependencies["l2u"]:
            return
        else:
            for adj in self.dependencies["l2u"][src]:
                path.append(adj)
                self.dfs(adj, dst, path, results)
                path.pop()

    def parse_dependency(self):
        if self.dependencies is None:
            self.dependencies = {"u2l": {}, "l2u": {}}
        self.dependencies.setdefault("u2l", {})
        self.dependencies.setdefault("l2u", {})

        for key, value_list in self.dependencies["u2l"].items():
            for value in value_list:
                key.add_paths(self.find_paths(src=value, dst=key))

        for key, value_list in self.dependencies["l2u"].items():
            for value in value_list:
                key.add_parent(value)
                value.add_child(key)

        for problem in self.problems:
            if self.check_leaf(problem):
                problem.leaf = True
                self.leaves.append(problem)

    def set_dependency(self, dependencies):
        self.dependencies = dependencies
        self.leaves = []
        for problem in self.problems:
            problem.leaf = False
            problem.clear_dependencies()
        self.parse_dependency()
        for problem in self.problems:
            problem.ready = [False] * len(problem.children)
            fo = [p.config.first_order for p in problem.parents]
            problem._first_order = all(fo) if fo else False
            problem._roll_back = self._roll_back and len(problem.parents) > 0
            problem._inner_loop_start = True

    def set_problem_attr(self, problem) -> str:
        """Name-attribute injection: every problem (and the engine and env)
        can address every other problem as ``self.<name>``."""
        name = problem.name
        assert not hasattr(self, name), f"Problem already named {name}!"
        setattr(self, name, problem)
        for prob in self.problems:
            if prob is not problem:
                assert not hasattr(prob, name)
                setattr(prob, name, problem)
        if self.env is not None:
            setattr(self.env, name, problem)
        return name

    # ------------------------------------------------------------------
    # training loop (reference engine.py:86-121)
    # ------------------------------------------------------------------
    def train_step(self):
        for leaf in self.leaves:
            leaf.step(global_step=self.global_step)

    def run(self):
        self.maybe_auto_resume()
        if self.config.compile_blocks:
            return self.run_compiled()
        return self._run_driver()

    def _profiler(self):
        """The trace of ``EngineConfig.profile_dir``, or no profiler."""
        if not self.config.profile_dir:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(self.config.profile_dir))

    def _run_driver(self):
        self.train()
        with self._profiler():
            for _ in range(1, self.train_iters + 1):
                self.global_step += 1
                self.train_step()
                if self.maybe_validate_checkpoint(window=1):
                    break
        self.cleanup()

    def run_compiled(self):
        """Compiled-block training loop (``betty_tpu/engine.py``'s
        ``run_compiled``): driver mode until the schedule reaches the
        simulator's steady phase and every problem is past its warm-up, then
        blocks of K periods (``compile.BlockRunner``), then the remainder in
        driver mode. Numerically equal to driver mode. The last runner is
        kept as ``block_runner``."""
        from betty_tpu_torch.compile import BlockRunner

        if type(self).train_step is not Engine.train_step:
            # a block replays the problems' steps and never calls an
            # overridden train_step (an env stepped there would not step)
            self.logger.info("[compile_blocks] falling back to driver mode: the engine "
                             "overrides train_step")
            return self._run_driver()
        try:
            probe = BlockRunner(self, schedule_only=True)
        except RuntimeError as e:
            # no periodic, causally complete block boundary for this
            # schedule: driver mode computes the same numbers
            self.logger.info(f"[compile_blocks] falling back to driver mode: {e}")
            return self._run_driver()
        self.train()
        with self._profiler():
            self._run_blocks(probe)
        self.cleanup()

    def _run_blocks(self, probe):
        """``run_compiled``'s loop: driver warm-up, blocks, driver remainder."""
        from betty_tpu_torch.compile import BlockRunner

        it = 0
        stopped = False

        def steady():
            return probe.live_phase() == probe.initial_phase and all(
                p.warmup_steps == 0 or p._count > p.warmup_steps for p in self.problems)

        while it < self.train_iters and not steady():
            it += 1
            self.global_step += 1
            self.train_step()
            if self.maybe_validate_checkpoint(window=1):
                stopped = True
                break

        # a block spans at most one validation or checkpoint boundary, so
        # validation, early stopping and checkpoints see what driver mode sees
        remaining = self.train_iters - it
        cadence = self.valid_step if self.do_validation() else remaining
        if self.config.checkpoint_step > 0 and self.config.checkpoint_dir:
            cadence = min(cadence, self.config.checkpoint_step)
        cadence = max(1, cadence)
        K = self.config.block_periods
        if K <= 0:
            K = min(max(1, min(cadence, max(remaining, 1), 512) // probe.period), 32)
        else:
            K = max(1, min(K, max(1, cadence // probe.period)))
        if probe.period > cadence:
            self.logger.info(
                f"[compile_blocks] schedule period {probe.period} exceeds the "
                f"validation/checkpoint cadence {cadence}: boundary actions run once per "
                "period (coarsened cadence)")
        period = probe.period * K
        runner = None
        if not stopped and remaining >= period:
            runner = self.block_runner = BlockRunner(self, periods=K)
        elif not stopped:
            self.logger.info(
                f"[compile_blocks] no blocks dispatched: {remaining} iterations remain after "
                f"the {it}-iteration warmup prefix, below the block size {period}")

        while not stopped and it + period <= self.train_iters:
            last_loss = runner.run_block()
            it += period
            self.global_step += period
            for p in self.problems:
                if p.log_step > 0 and p.name in last_loss:
                    p.log(last_loss[p.name], self.global_step)
            if self.maybe_validate_checkpoint(window=period):
                stopped = True

        # the remainder runs in driver mode, from the blocks' roll-back caches
        if runner is not None:
            runner.finalize()
        if not stopped:
            for _ in range(self.train_iters - it):
                self.global_step += 1
                self.train_step()
                if self.maybe_validate_checkpoint(window=1):
                    break

    def maybe_auto_resume(self):
        """With ``EngineConfig(auto_resume=True)``, restore the checkpoint in
        ``checkpoint_dir`` if one is there (before the first step only);
        ``train_iters`` is the total target of the run, so only the
        remainder runs."""
        if not (self.config.auto_resume and self.config.checkpoint_dir
                and self.global_step == 0
                and os.path.exists(os.path.join(self.config.checkpoint_dir, "meta.json"))):
            return
        self.load_checkpoint(self.config.checkpoint_dir)
        self.train_iters = max(0, self.train_iters - self.global_step)
        self.logger.info(f"[auto_resume] restored global step {self.global_step} from "
                         f"{self.config.checkpoint_dir}; {self.train_iters} iterations remain")

    def maybe_validate_checkpoint(self, window: int = 1) -> bool:
        """Validation on the ``valid_step`` cadence and a checkpoint on the
        ``checkpoint_step`` one, in that order, for both loops; a window of
        W means the global step just advanced by W iterations, and a
        multiple of the cadence inside it triggers. True when early
        stopping fires."""
        stop = False
        if self.do_validation() and self.global_step % self.valid_step < window:
            self.eval()
            validation_stats = self._agree(self.validation() or {})
            self.logger.info(f"[Validation] [Global Step {self.global_step}] "
                             f"{log_from_loss_dict(validation_stats)}")
            self.logger.log(validation_stats, tag="validation", step=self.global_step)
            self.train()
            if self.early_stopping is not None and self.early_stopping(validation_stats):
                self.logger.info("Early stopping is executed!")
                stop = True
        if (self.config.checkpoint_step > 0 and self.config.checkpoint_dir is not None
                and self.global_step % self.config.checkpoint_step < window):
            self.save_checkpoint(self.config.checkpoint_dir)
        return stop

    def save_checkpoint(self, path: str):
        """Every problem's state and the host counters into ``path``
        (``checkpoint.save_engine_state``)."""
        from betty_tpu_torch.checkpoint import save_engine_state

        save_engine_state(self, path)

    def load_checkpoint(self, path: str):
        """The state and counters of the checkpoint in ``path``
        (``checkpoint.restore_engine_state``)."""
        from betty_tpu_torch.checkpoint import restore_engine_state

        restore_engine_state(self, path)

    def train(self):
        for problem in self.problems:
            problem.train()

    def eval(self):
        for problem in self.problems:
            problem.eval()

    def do_validation(self) -> bool:
        # every rank validates, so that collectives inside validation and
        # the early-stopping decision stay aligned across ranks
        return self.is_implemented("validation") and self.valid_step > 0

    def _agree(self, stats):
        """Under a mesh, the numbers of ``stats`` averaged over the ranks
        (each rank may have validated on its own data)."""
        if self.mesh is None:
            return stats
        keys = [k for k, v in stats.items()
                if isinstance(v, (int, float)) or (torch.is_tensor(v) and v.numel() == 1)]
        if not keys:
            return stats
        vals = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64,
                            device=self.device)
        vals = parallel.grad_mean(vals, self.mesh)
        return {**stats, **{k: float(v) for k, v in zip(keys, vals.tolist())}}

    def cleanup(self):
        self.logger.info("Multilevel optimization finished!")

    def is_implemented(self, fn_name: str) -> bool:
        return callable(getattr(self, fn_name, None))


def _check_on_card(name, state, device):
    """A rank's state must live on the rank's own card. A module built
    before the process group chose that card (``configure_systems``, or
    ``parallel.maybe_init_distributed`` called first, as the examples do)
    sits on card 0."""
    for x in tree_leaves(state):
        if isinstance(x, torch.Tensor) and x.is_cuda and x.device != device:
            raise RuntimeError(
                f"problem {name!r}: a state tensor is on {x.device} but this rank runs on "
                f"{device}; call parallel.maybe_init_distributed() before building the "
                "modules so that every rank builds on its own card")


class _RankLogger(LoggerBase):
    """The logger of ranks other than 0: warnings and errors only."""

    def info(self, msg):
        pass

    def debug(self, msg):
        pass
