"""ImageNet data pruning: the port's ``examples/imagenet_pruning.py``
against the JAX example, and its own invariants.

* The program at ``tests/test_examples2.py``'s arguments in float64 from
  the same weights: both problems' parameters, the EMA teacher and the
  running statistics within 1e-8 after 4 iterations at ``--gas 2``, counts
  4:2 and an accumulation boundary at the end; the same under ``--augment
  device`` (40 -> 32, JAX's draws injected by step key); the npz branch
  with ``top1`` equal to JAX's (``torch_pruning_impl.py``, in a
  subprocess).
* Compiled blocks equal driver mode bit for bit, with and without device
  augmentation (the crops of a replay are driver mode's: the generator is
  reseeded from the step seed); a run resumed from a checkpoint equals the
  uninterrupted one bit for bit (the teacher travels in ``extra``).
* The teacher starts as a copy of the student, not an alias, and moves;
  ``--device_data`` draws the sets from a seeded generator on the device;
  ``--precision bf16`` keeps float32 running statistics; the CLI's defaults
  are the JAX example's; other strategies raise.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu_torch.examples import imagenet_pruning as tprune
from betty_tpu_torch.utils import tree_leaves
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
CASES = ("pruning", "pruning_augment", "pruning_npz")
SMALL = ["--device", "cpu", "--batch_size", "4", "--image_size", "32", "--num_classes", "10",
         "--width", "8", "--stages", "1", "1", "--gas", "2", "--ema_decay", "0.9",
         "--train_size", "32", "--meta_size", "16"]
AUGMENT = ["--image_size", "40", "--crop_size", "32", "--augment", "device"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _engine(iters, *extra, compiled=False):
    argv = SMALL + ["--train_iters", str(iters), *extra]
    engine = tprune.build_engine(tprune.parse_args(argv + (["--compile_blocks"] if compiled
                                                           else [])))
    engine.config.block_periods = 1
    return engine


@pytest.fixture(scope="module")
def pruning_runs():
    return run_robust_impl(CASES, script="torch_pruning_impl.py")


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(pruning_runs, case):
    lines = pruning_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_compiled_equals_driver(augment):
    extra = AUGMENT if augment else []
    driver = _engine(8, *extra)
    driver.run()
    compiled = _engine(8, *extra, compiled=True)
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.period == 2 and runner.periods_run >= 2
    assert (compiled.classifier.count, compiled.reweight.count) == (8, 4)
    equal_trees(driver.states, compiled.states)


def test_resumed_equals_uninterrupted(tmp_path):
    def build(iters, auto=False):
        engine = _engine(iters, *AUGMENT)
        engine.config.checkpoint_dir, engine.config.checkpoint_step = str(tmp_path), 2
        engine.config.auto_resume = auto
        return engine

    full = build(6)
    full.config.checkpoint_step = 0
    full.run()
    build(2).run()
    resumed = build(6, auto=True)
    resumed.run()
    assert resumed.classifier.count == 6
    assert "teacher_params" in resumed.states["classifier"]["extra"]
    equal_trees(full.states, resumed.states)


def test_teacher_is_a_copy_and_moves():
    engine = _engine(2)
    state = engine.states["classifier"]
    teacher, params = state["extra"]["teacher_params"], state["params"]
    assert set(teacher) == set(params)
    for k in params:
        assert torch.equal(teacher[k], params[k])
        assert teacher[k].data_ptr() != params[k].data_ptr()
    before = {k: t.clone() for k, t in teacher.items()}
    engine.run()
    after = engine.states["classifier"]["extra"]["teacher_params"]
    # one optimizer step at --gas 2: the teacher moved by (1 - 0.9) of the way
    new = engine.states["classifier"]["params"]
    for k in before:
        torch.testing.assert_close(after[k], 0.9 * before[k] + 0.1 * new[k], rtol=0, atol=0)
    assert any(not torch.equal(before[k], after[k]) for k in before)


def test_device_data_draws_on_the_device():
    engine = _engine(2, "--device_data")
    x, y = engine.classifier.train_data_loader[0].arrays
    assert isinstance(x, torch.Tensor) and x.shape == (32, 32, 32, 3)
    assert y.dtype == torch.int64 and 0 <= int(y.min()) and int(y.max()) < 10
    again = _engine(2, "--device_data").classifier.train_data_loader[0].arrays[0]
    assert torch.equal(x, again)
    engine.run()
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(engine.states)
               if torch.is_tensor(t) and t.is_floating_point())


def test_bf16_keeps_float32_statistics():
    engine = _engine(2, "--precision", "bf16")
    engine.run()
    stats = engine.states["classifier"]["extra"]["batch_stats"]
    assert all(t.dtype == torch.float32 for t in stats.values())
    assert any(not torch.equal(t, torch.zeros_like(t)) for k, t in stats.items()
               if k.endswith("running_mean"))
    assert all(t.dtype == torch.float32 for t in engine.states["classifier"]["params"].values())


def test_unported_strategy_raises():
    # tp is ported, but needs a model axis on the mesh, which the pruning
    # example does not lay out
    args = tprune.parse_args(SMALL + ["--strategy", "tp"])
    with pytest.raises(ValueError, match="model axis"):
        tprune.build_engine(args)


def test_cli_defaults_are_the_jax_example():
    ours = vars(tprune.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "imagenet_pruning" / "main.py")
    assert ours["device"] == "cuda" and not ours["compile_blocks"]
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device", "compile_blocks"}


def test_synthetic_data_is_the_jax_examples():
    spec = importlib.util.spec_from_file_location(
        "pruning_main", ROOT / "examples" / "imagenet_pruning" / "main.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    for got, want in zip(tprune.make_synthetic_imagenet(8, 10, 16, seed=1),
                         jmod.make_synthetic_imagenet(8, 10, 16, seed=1)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
