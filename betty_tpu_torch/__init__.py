"""betty_tpu_torch: the PyTorch/CUDA port of betty_tpu for one NVIDIA H100.

The same multilevel-optimization API (``Problem``/``Engine``, the darts and
SAMA hypergradient solvers) over explicit parameter dicts, with the Pallas
kernels of the JAX package replaced by hand-written CUDA kernels
(``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. The package imports torch and never JAX.
"""

__version__ = "0.1.0"

from betty_tpu_torch.configs import Config, EngineConfig
from betty_tpu_torch.engine import Engine
from betty_tpu_torch.problems import ImplicitProblem, PenaltyProblem, Problem
from betty_tpu_torch import module, optim, utils

__all__ = [
    "Config",
    "EngineConfig",
    "Engine",
    "Problem",
    "ImplicitProblem",
    "PenaltyProblem",
    "module",
    "optim",
    "utils",
]
