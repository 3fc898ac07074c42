"""The port's ``reinforce`` solver (``hypergradient/reinforce.py``).

* JAX's directions injected: the solver called directly and two meta steps
  of an Engine equal betty_tpu's within 1e-10 in float64
  (``torch_itd_impl.py reinforce``, in a subprocess).
* The counterparts of tests/test_reinforce.py on the logistic-regression
  HPO program, with the port's own Gaussian directions: the estimate
  converges to darts as the samples grow, it sees through a piecewise
  constant coupling where darts sees zero, and it optimizes the bilevel
  program below the reference's bar.
* Compiled blocks draw driver mode's directions: compiled equals driver
  bit for bit.
"""

import numpy as np
import pytest
import torch

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from betty_tpu_torch.module import from_fn
from test_torch_itd import run_impl


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them (a hundred times
    slower on a loaded machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(inner_config, iters, inner_cls=lr.Inner, compiled=False, seed=0):
    """The port's counterpart of ``fixtures.make_engine``."""
    train, valid = lr.make_data(seed=seed)
    outer = lr.Outer(name="outer",
                     module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9), train_data_loader=[valid],
                     config=Config())
    inner = inner_cls(name="inner",
                      module=from_fn(lambda p, x: (x @ p["w"], p["w"]), {"w": torch.zeros(20)}),
                      optimizer=optim.sgd(lr=0.1), train_data_loader=[train],
                      config=inner_config)
    engine = Engine(config=EngineConfig(train_iters=iters, compile_blocks=compiled),
                    problems=[outer, inner],
                    dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                    device="cpu")
    return engine, outer


def _outer_delta(inner_config, inner_cls=lr.Inner, seed=0):
    """The outer parameters' move in one meta step."""
    engine, _ = _engine(inner_config, 1, inner_cls, seed=seed)
    before = engine.states["outer"]["params"]["w"].clone()
    engine.run()
    return (engine.states["outer"]["params"]["w"] - before).numpy()


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_reinforce_with_jax_directions_matches_betty_tpu_in_float64():
    out = run_impl(["reinforce"])
    lines = [line for line in out.splitlines() if '"case": "reinforce"' in line]
    assert len(lines) == 1 and lines[0].startswith("OK "), lines


def test_reinforce_converges_to_darts_on_smooth_loss():
    # one meta step: the outer loss reaches its params only through inner,
    # so the outer move is -lr times the solver's output
    d_darts = _outer_delta(Config(type="darts", unroll_steps=1))
    d_rf = _outer_delta(Config(type="reinforce", unroll_steps=1, reinforce_samples=4096,
                               reinforce_sigma=1e-3))
    ratio = float(np.linalg.norm(d_rf) / np.linalg.norm(d_darts))
    assert _cos(d_darts, d_rf) > 0.98, _cos(d_darts, d_rf)
    assert 0.8 < ratio < 1.2, ratio
    d_small = _outer_delta(Config(type="reinforce", unroll_steps=1, reinforce_samples=64,
                                  reinforce_sigma=1e-3))
    assert np.linalg.norm(d_rf - d_darts) < np.linalg.norm(d_small - d_darts)


class _QuantizedInner(lr.Inner):
    """The weight decay snapped to a 0.25 grid: the inner loss is piecewise
    constant in the outer parameters, so darts' gradient through it is 0."""

    QUANT = 0.25

    def training_step(self, batch):
        inputs, targets = batch
        outs, params = self.module(inputs)
        lam = torch.round(self.outer() / self.QUANT) * self.QUANT
        return lr.bce(outs, targets) + 0.5 * torch.sum(lam * params * params)


def test_reinforce_sees_through_piecewise_constant_coupling():
    d_darts = _outer_delta(Config(type="darts", unroll_steps=1), _QuantizedInner, seed=3)
    assert np.allclose(d_darts, 0.0, atol=1e-12), d_darts
    d_ref = _outer_delta(Config(type="darts", unroll_steps=1), seed=3)
    d_rf = _outer_delta(Config(type="reinforce", unroll_steps=1, reinforce_samples=4096,
                               reinforce_sigma=0.25), _QuantizedInner, seed=3)
    assert np.linalg.norm(d_rf) > 1e-6
    assert _cos(d_ref, d_rf) > 0.7, _cos(d_ref, d_rf)


def test_reinforce_optimizes_bilevel_fixture():
    engine, outer = _engine(Config(type="reinforce", unroll_steps=100, reinforce_samples=32,
                                   reinforce_sigma=0.01), 2000)
    engine.run()
    assert lr.final_outer_loss(engine, outer) < 0.48


def test_reinforce_compiled_blocks_match_driver():
    """The directions come from the block's generator pool, reseeded before
    every period with driver mode's seeds: compiled equals driver bit for
    bit."""
    runs = {}
    for compiled in (False, True):
        cfg = Config(type="reinforce", unroll_steps=10, reinforce_samples=8,
                     reinforce_sigma=0.01)
        runs[compiled], _ = _engine(cfg, 50, compiled=compiled)
        runs[compiled].run()
    assert runs[True].block_runner.periods_run == 5
    for name in ("outer", "inner"):
        assert torch.equal(runs[False].states[name]["params"]["w"],
                           runs[True].states[name]["params"]["w"]), name
    assert not torch.equal(runs[True].states["outer"]["params"]["w"], torch.ones(20))
