"""Learning by ignoring: the port's ``examples/learning_by_ignoring.py``
against the JAX package's ``examples/learning_by_ignoring/main.py``.

* The program at ``tests/test_examples.py``'s arguments (``features_lr``
  0.08, ``classifier_lr`` 0.02, so the two parameter groups differ) for 4
  iterations in float64 from the same weights: every problem's parameters
  within 1e-8 of JAX, counts 4:4:4, JAX's two paths into ``reweight``;
  and SAMA's preconditioning with a grouped Adam within 1e-10
  (``torch_programs_impl.py lbi sama_grouped``, in a subprocess).
* The groups: ``layers.0.`` takes ``features_lr`` and every other leaf
  ``classifier_lr``, and the first step moves each group by its own rate.
* Compiled blocks equal driver mode bit for bit; the CLI's defaults are
  the JAX example's; ``--data-dir`` reads a feature npz.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu_torch import optim
from betty_tpu_torch.examples import learning_by_ignoring as tlbi
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
CASES = ("lbi", "sama_grouped")
SMALL = ["--device", "cpu", "--dim", "16", "--classes", "3", "--n_source", "128", "--n_target",
         "128", "--batch", "32", "--features_lr", "0.08", "--classifier_lr", "0.02"]

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def lbi_runs():
    return run_robust_impl(CASES, script="torch_programs_impl.py")


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(lbi_runs, case):
    lines = lbi_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def test_groups_step_with_their_own_learning_rates():
    engine = tlbi.build_engine(tlbi.parse_args(SMALL + ["--train_iters", "1"]))
    opt = engine.finetune.optimizer
    assert isinstance(opt, optim.GroupedOptimizer)
    assert opt.labels == {"layers.0.weight": 0, "layers.0.bias": 0, "layers.1.weight": 1,
                          "layers.1.bias": 1}
    assert [m["lr"] for m in opt.group_meta] == [0.08, 0.02]
    before = dict(engine.states["finetune"]["params"])
    engine.run()
    state = engine.states["finetune"]
    # SGD with momentum: the first step's trace is the gradient
    traces = {k: v for g in state["opt_state"]["groups"] for k, v in g["trace"].items()}
    for name, p in state["params"].items():
        lr = 0.08 if name.startswith("layers.0.") else 0.02
        torch.testing.assert_close(p - before[name], -lr * traces[name], rtol=1e-5, atol=1e-7)


def test_compiled_equals_driver_bit_for_bit():
    argv = SMALL + ["--train_iters", "8"]
    driver = tlbi.build_engine(tlbi.parse_args(argv))
    driver.run()
    compiled = tlbi.build_engine(tlbi.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.period == 1 and runner.periods_run >= 4
    assert [p.count for p in compiled.problems] == [p.count for p in driver.problems] == [8] * 3
    equal_trees(driver.states, compiled.states)


def test_cli_defaults_are_the_jax_example():
    ours = vars(tlbi.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "learning_by_ignoring" / "main.py")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device", "compile_blocks"}


def test_data_dir_reads_a_feature_npz(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {}
    for split, n in (("src", 64), ("tgt", 64), ("val", 64), ("test", 40)):
        arrays[f"x_{split}"] = rng.randn(n, 12).astype(np.float32)
        arrays[f"y_{split}"] = rng.randint(0, 4, n).astype(np.int32)
    path = tmp_path / "features.npz"
    np.savez(path, **arrays)
    args = tlbi.parse_args(["--device", "cpu", "--batch", "16", "--train_iters", "2",
                            "--data-dir", str(path)])
    engine = tlbi.build_engine(args)
    assert (args.n_source, args.n_target, args.dim, args.classes) == (64, 64, 12, 4)
    engine.run()
    stats = engine.validation()
    assert 0.0 <= stats["test_acc"] <= 100.0
    assert engine.states["reweight"]["params"]["scores"].shape == (64,)
