from betty_tpu_torch.problems.implicit import ImplicitProblem, PenaltyProblem
from betty_tpu_torch.problems.iterative import IterativeProblem
from betty_tpu_torch.problems.problem import Problem

__all__ = ["Problem", "ImplicitProblem", "IterativeProblem", "PenaltyProblem"]
