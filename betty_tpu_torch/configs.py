"""Configuration dataclasses for problems and the engine.

Field-for-field copy of ``betty_tpu/configs.py`` so that a program written
for the JAX package configures the port unchanged. On one CUDA card some
fields have no meaning and are accepted but inert:

* ``Config``: ``initial_dynamic_scale``/``scale_factor`` (bf16 needs no loss
  scaling; ``"fp16"`` is treated as ``"bf16"``), ``retain_graph`` and
  ``allow_unused``.
* ``EngineConfig``: ``backend``, ``compile_cache_dir`` and ``rng_impl``.

``EngineConfig.donate_state`` (default off, as in JAX) updates every state
leaf an update replaces (parameters, optimizer moments, ``grad_acc``,
``last_grad``, the mutated ``extra``, a hook's edits) in its own storage,
in driver mode and in compiled blocks, with the values of ``False`` bit for
bit. JAX's rule holds: no problem donates while any problem keeps a
roll-back cache or is an ``IterativeProblem`` (references to old states).
As with JAX's donated buffers, the tensors the state starts from are
consumed: a ``from_torch`` module's own parameters (which the initial state
shares) and a state given to ``load_state_dict`` take the updates; leaves
that share memory are copied apart when ``Engine.run`` starts.

``EngineConfig.strategy`` is ``"default"`` (one process, no collectives)
or a strategy over ``torch.distributed`` (``betty_tpu_torch/parallel``):
data-parallel ``"dp"`` (alias ``"distributed"``), ``"zero"`` or ``"fsdp"``;
tensor-parallel ``"tp"``, whose layouts ``Config.shard_rules`` overrides
(``(regex, partition-spec tuple)`` pairs, the regex searched in the port's
leaf names, the spec over the port's dims, as in
``parallel.tp_shardings``); expert-parallel ``"ep"``; pipeline-parallel
``"pp"`` (GPipe over the stage-stacked blocks of
``models.make_pipelined_transformer``); or sequence-parallel ``"sp"``
(parameters replicated; the module built with ``seq_axis="sp"``).
``mesh_shape`` lays the ranks out (``(("dp", N),)`` by default, ``(("dcn",
M), ("dp", N))``, and for the model-parallel strategies one model axis
last: ``(("dp", N), ("mdl", M))``, ``("ep", M)``, ``("pp", M)`` or
``("sp", M)``, or up to four different ones, as the JAX package's
``(("dp", N), ("mdl", M), ("pp", S))`` under ``"tp"`` with two-dim
``shard_rules`` (``models.COMPOSED_SHARD_RULES``) or ``(("dp", 1), ("mdl",
2), ("pp", 2), ("sp", 2))``; the data-parallel strategies also take a
``pp`` or ``sp`` axis, whose module splits the depth or the sequence
itself), and ``autoshard_data`` gives each rank its examples of every
``ArrayLoader`` (``data.shard_loader``). On every such mesh every strategy
runs, ITD replays included, and an axis a module does not split repeats
its work.

``EngineConfig.profile_dir`` writes a ``torch.profiler`` trace of the run
there (``Engine._profiler``).

``compile_blocks=True`` runs the steady schedule as compiled blocks
(``betty_tpu_torch/compile.py``: on CUDA one graph replay a meta-period);
``block_periods`` is the periods a block (0: the JAX package's automatic
size, the validation cadence over the period, at most 32).

``Config.remat`` recomputes the problem's direct loss in the backward
(``Problem.build_update_fn``). ``checkpoint_dir`` / ``checkpoint_step`` /
``auto_resume`` are the engine's checkpoints (``betty_tpu_torch/checkpoint.py``):
a save every ``checkpoint_step`` global steps, and a run that starts from
the checkpoint in ``checkpoint_dir`` when one is there.

``Config.hvp_mode`` other than ``"jvp"``/``"vjp"`` raises, as the JAX
package's ``make_hvp`` does.
"""

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    """Per-problem training configuration (``betty_tpu.configs.Config``)."""

    type: str = "darts"
    unroll_steps: int = 1
    first_order: bool = True
    retain_graph: bool = False
    allow_unused: bool = True

    gradient_accumulation: int = 1
    gradient_clipping: float = 0.0

    # "fp32" | "bf16" ("fp16" is treated as "bf16")
    precision: str = "fp32"
    initial_dynamic_scale: float = 4096.0
    scale_factor: float = 2.0
    # precision of the hypergradient pipeline when ``precision`` is reduced:
    # "fp32" runs the direct cross-gradient and the solver's perturbed
    # evaluations without the bf16 cast
    solver_precision: str = "fp32"

    warmup_steps: int = 0

    log_step: int = -1
    log_local_step: bool = False

    darts_alpha: float = 0.01
    darts_multitask: bool = False

    sama_adam_alpha: float = 1.0
    sama_multitask: bool = False

    neumann_iterations: int = 1
    neumann_alpha: float = 1.0

    cg_iterations: int = 1
    cg_alpha: float = 1.0

    reinforce_alpha: float = 0.01
    reinforce_sigma: float = 0.01
    reinforce_samples: int = 4

    use_fused_vector_ops: bool = False
    hvp_mode: str = "jvp"
    remat: bool = False
    shard_rules: Optional[Tuple] = None

    def __post_init__(self):
        if self.hvp_mode not in ("jvp", "vjp"):
            raise ValueError(f"hvp_mode must be 'jvp' or 'vjp', got {self.hvp_mode!r}")


@dataclass
class EngineConfig:
    """Global engine configuration (``betty_tpu.configs.EngineConfig``)."""

    train_iters: int = 50000
    valid_step: int = 500

    logger_type: str = "none"

    roll_back: bool = False

    backend: str = "xla"
    strategy: str = "default"

    early_stopping: bool = False
    early_stopping_mode: str = "min"
    early_stopping_tolerance: int = 5
    early_stopping_metric: str = "loss"

    mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None
    compile_blocks: bool = False
    block_periods: int = 0
    donate_state: bool = False
    autoshard_data: bool = True
    profile_dir: Optional[str] = None
    compile_cache_dir: Optional[str] = "auto"
    rng_impl: str = "threefry"
    checkpoint_dir: Optional[str] = None
    checkpoint_step: int = 0
    auto_resume: bool = False

    def __post_init__(self):
        from betty_tpu_torch.parallel.mesh import DP_STRATEGIES, MODEL_STRATEGIES, check_axes

        known = DP_STRATEGIES + MODEL_STRATEGIES
        if self.strategy != "default" and self.strategy not in known:
            raise ValueError(f"EngineConfig.strategy={self.strategy!r}: one of 'default', "
                             + ", ".join(repr(s) for s in known))
        check_axes(self.mesh_shape)
