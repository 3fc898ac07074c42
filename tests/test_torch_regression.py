"""The port's logistic-regression HPO program (the reference's regression
gate) with the CG and Neumann solvers: 2000 iterations with
``unroll_steps=100`` end below the outer loss of 0.48 that
tests/test_regression.py demands of betty_tpu, and 200 iterations follow
betty_tpu's trajectory on the same data within 1e-5 (float32)."""

import numpy as np
import pytest

from betty_tpu import Config as JConfig
from betty_tpu import EngineConfig as JEngineConfig
from betty_tpu_torch import Config
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from fixtures import make_engine

THRESHOLD = 0.48
SOLVERS = {
    "cg": dict(type="cg", cg_iterations=3, cg_alpha=0.1, unroll_steps=100),
    "neumann": dict(type="neumann", neumann_iterations=5, unroll_steps=100),
}


def _run(solver, train_iters):
    args = lr.parse_args(["--device", "cpu", "--train_iters", str(train_iters)])
    engine, outer = lr.build_engine(args, Config(**SOLVERS[solver]))
    engine.run()
    return engine, outer


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_regression_gate(solver):
    engine, outer = _run(solver, 2000)
    assert lr.final_outer_loss(engine, outer) < THRESHOLD


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_trajectory_matches_betty_tpu(solver):
    engine, _ = _run(solver, 200)
    jengine, _, _ = make_engine(JConfig(**SOLVERS[solver]), JEngineConfig(train_iters=200))
    jengine.run()
    for name in ("outer", "inner"):
        got = engine.states[name]["params"]["w"].numpy()
        want = np.asarray(jengine.states[name]["params"]["w"])
        assert np.max(np.abs(got - want)) <= 1e-5, name
    # the outer weights (initialised to ones) really moved
    assert np.max(np.abs(np.asarray(jengine.states["outer"]["params"]["w"]) - 1.0)) > 1e-2
