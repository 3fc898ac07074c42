from betty_tpu_torch.problems.implicit import ImplicitProblem, PenaltyProblem
from betty_tpu_torch.problems.problem import Problem

__all__ = ["Problem", "ImplicitProblem", "PenaltyProblem"]
