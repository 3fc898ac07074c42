"""The 4-level saliency-aware NAS: the port's
``examples/saliency_aware_nas_4_level.py`` against the JAX package's
``examples/saliency_aware_nas_4_level/main.py``.

* The program (dim 16, 3 classes, batch 32, 2 PGD steps, unroll 2 and 2)
  for 8 inner1 steps in float64 from the same weights: all three
  problems' parameters within 1e-8, JAX's three paths into the outer
  problem (one through two darts hops), counts 8:4:2
  (``torch_robust_impl.py sanas``, in a subprocess).
* ``tests/test_examples2.py::test_sanas_budget_receives_data_gradient``'s
  run (6 PGD steps: the projection binds) and the budget's gradient at
  JAX's state, element by element within 1e-10, with the tied elements
  counted (``torch_robust_impl.py budget``).
* The projection's tie: ``d/deps`` of ``minimum(maximum(delta, -eps),
  eps)`` at ``delta == +-eps`` is JAX's ``jnp.clip``'s (+-0.5), where
  ``torch.clamp`` gives 0.
* The schedule: the port's ``_Simulator`` and ``compress`` give JAX's
  events, period and phase on this graph, and compiled blocks equal
  driver mode bit for bit on the CPU.
* The CLI's defaults are the JAX example's.
"""

from pathlib import Path
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu_torch import compile as tcompile
from betty_tpu_torch.examples import saliency_aware_nas_4_level as tsanas
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
CASES = ("sanas", "budget")
SMALL = ["--device", "cpu", "--dim", "16", "--classes", "3", "--n", "256", "--batch", "32",
         "--pgd_steps", "2", "--valid_step", "1000"]

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def sanas_runs():
    return run_robust_impl(CASES)


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(sanas_runs, case):
    lines = sanas_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def test_projection_splits_tie_gradients_as_jax():
    """After the attack every clipped element of delta equals +-eps
    exactly; there ``jnp.clip`` (``lax.max``/``lax.min``) sends half the
    gradient to the bound. ``torch.clamp`` with tensor bounds sends none,
    which would cut the budget's only data-dependent gradient in half."""
    eps = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    delta = np.array([0.5, -0.5, 0.2, 0.9], np.float32)  # +eps tie, -eps tie, inside, above
    want = np.asarray(jax.grad(lambda e: jnp.sum(jnp.clip(jnp.asarray(delta), -e, e)))(
        jnp.asarray(eps)))
    np.testing.assert_array_equal(want, [0.5, -0.5, 0.0, 1.0])

    def port_grad(project):
        e = torch.tensor(eps, requires_grad=True)
        (g,) = torch.autograd.grad(project(torch.tensor(delta), e).sum(), e)
        return g.numpy()

    np.testing.assert_array_equal(port_grad(tsanas.project), want)
    np.testing.assert_array_equal(port_grad(lambda d, e: torch.clamp(d, -e, e)),
                                  [0.0, 0.0, 0.0, 1.0])


def _jax_engine(spec):
    sys.path.insert(0, str(ROOT / "tests"))
    from test_examples2 import load

    mod = load("saliency_aware_nas_4_level")
    return mod.build_engine(type("A", (), dict(spec)))


def test_simulator_gives_jax_schedule():
    from betty_tpu import compile as jcompile

    spec = dict(dim=16, classes=3, n=256, batch=32, lr=0.05, arch_lr=1e-3, budget_lr=1e-3,
                pgd_steps=2, pgd_lr=0.05, unroll1=2, unroll2=2, train_iters=8, log_step=-1)
    jeng = _jax_engine(spec)
    teng = tsanas.build_engine(tsanas.parse_args(SMALL))
    jev, jperiod, jphase = jcompile._Simulator(jeng).run()
    tev, tperiod, tphase = tcompile._Simulator(teng).run()
    assert [dataclasses.asdict(e) for e in tev] == [dataclasses.asdict(e) for e in jev]
    assert (tperiod, tphase) == (jperiod, jphase) and tperiod == 4
    jprobs = {p.name: p for p in jeng.problems}
    tprobs = {p.name: p for p in teng.problems}
    seg = lambda segs: [(s.name, s.is_scan, len(s.events)) for s in segs]  # noqa: E731
    assert seg(tcompile.compress(tev, tprobs)) == seg(jcompile.compress(jev, jprobs))
    assert [[q.name for q in p] for p in teng.outer.paths] == \
        [[q.name for q in p] for p in jeng.outer.paths]


def test_compiled_equals_driver_bit_for_bit():
    argv = SMALL + ["--train_iters", "16"]
    driver = tsanas.build_engine(tsanas.parse_args(argv))
    driver.run()
    compiled = tsanas.build_engine(tsanas.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.period == 4 and runner.periods_run >= 3
    assert [p.count for p in compiled.problems] == [p.count for p in driver.problems] == [4, 8, 16]
    equal_trees(driver.states, compiled.states)


def test_cli_defaults_are_the_jax_example():
    ours = vars(tsanas.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "saliency_aware_nas_4_level" / "main.py")
    theirs.pop("data_dir")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device", "compile_blocks"}


def test_validation_reads_masked_accuracy():
    engine = tsanas.build_engine(tsanas.parse_args(SMALL + ["--train_iters", "4"]))
    engine.run()
    stats = engine.validation()
    assert 0.0 <= stats["masked_acc"] <= 100.0
    assert len(engine.test_data[1]) == 51  # the held-out fifth of the outer split
    assert torch.isfinite(engine.states["inner2"]["params"]["eps"]).all()
