"""ImplicitProblem and PenaltyProblem (``betty_tpu/problems/implicit.py``).

The functional base class already does what the reference's
``implicit_problem.py`` adds: ``last_grad`` for SAMA is a state field set
by the optimizer step, and the roll-back cache is a reference to the old
state dict.
"""

from betty_tpu_torch.problems.problem import Problem


class ImplicitProblem(Problem):
    """Approximate implicit differentiation (AID) problem."""


class PenaltyProblem(ImplicitProblem):
    """Penalty-based MLO problem: ``ImplicitProblem`` without the SAMA
    ``last_grad`` state."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._needs_last_grad = False
