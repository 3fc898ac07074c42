"""Engine: dependency-graph parsing and the training-loop driver.

Counterpart of ``betty_tpu/engine.py`` in driver mode. The graph mechanics
(``find_paths`` DFS, leaf detection, name-attribute injection, the step
recursion driven from the leaves) keep the reference's semantics;
``configure_systems`` only chooses the device: ``"cuda"`` unless the caller
passes another. States live in ``engine.states`` (name -> state dict).

Not ported in this slice: compiled blocks, meshes and strategies other than
one device, profiling, and engine checkpoints.
"""

import time
from typing import Dict, List, Optional

import torch

from betty_tpu_torch.configs import EngineConfig
from betty_tpu_torch.logging import logger
from betty_tpu_torch.misc.early_stopping import EarlyStopping
from betty_tpu_torch.utils import log_from_loss_dict


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
        """One device; a CUDA device must exist (no fallback to the CPU)."""
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: device 'cuda' requested but no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")

    def initialize(self):
        self.parse_config()
        self.configure_systems()

        self.logger = logger(logger_type=self.logger_type)
        self.logger.info("Initializing Multilevel Optimization...")
        start = time.time()

        self.parse_dependency()
        for problem in self.problems:
            self.set_problem_attr(problem)

        if self.env is not None:
            self.env.engine = self
            self.env.initialize()

        for i, problem in enumerate(self.problems):
            problem.add_logger(self.logger)
            if len(problem.parents) > 0:
                problem._roll_back = self._roll_back
            if self.env is not None:
                problem.add_env(self.env)
            problem.initialize(self)
            self.states[problem.name] = problem.init_state(i)

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
        self.train()
        for _ in range(1, self.train_iters + 1):
            self.global_step += 1
            self.train_step()
            if self.maybe_validate():
                break
        self.cleanup()

    def maybe_validate(self) -> bool:
        """Validation on the ``valid_step`` cadence; True when early stopping
        fires."""
        if not (self.do_validation() and self.global_step % self.valid_step == 0):
            return False
        self.eval()
        validation_stats = self.validation() or {}
        self.logger.info(f"[Validation] [Global Step {self.global_step}] "
                         f"{log_from_loss_dict(validation_stats)}")
        self.logger.log(validation_stats, tag="validation", step=self.global_step)
        self.train()
        if self.early_stopping is not None and self.early_stopping(validation_stats):
            self.logger.info("Early stopping is executed!")
            return True
        return False

    def train(self):
        for problem in self.problems:
            problem.train()

    def eval(self):
        for problem in self.problems:
            problem.eval()

    def do_validation(self) -> bool:
        return self.is_implemented("validation") and self.valid_step > 0

    def cleanup(self):
        self.logger.info("Multilevel optimization finished!")

    def is_implemented(self, fn_name: str) -> bool:
        return callable(getattr(self, fn_name, None))
