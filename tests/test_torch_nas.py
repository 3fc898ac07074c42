"""The DARTS search: the port's ``examples/neural_architecture_search.py``
against the JAX package's ``examples/neural_architecture_search/main.py``.

* The search (C2 L1 B4, 4 meta-periods, darts, ``roll_back=True``) from the
  same weights on the same batches in float64 (``torch_nas_impl.py search``,
  in a subprocess, about a minute): parameters, alphas and batch_stats
  within 1e-8, the same genotype. One darts hypergradient at L3 is in
  ``test_torch_nas_hypergradient.py``, the evaluation phase in
  ``test_torch_nas_eval.py``.
* Compiled blocks equal driver mode bit for bit on the CPU (roll-back;
  1,399 parameter leaves at full width, 191 here).
* A search cut and resumed by ``auto_resume`` equals the uninterrupted one
  (the ``affine=False`` BatchNorms' statistics in the checkpoint).
* The CLIs of both examples: the JAX examples' defaults (the published
  DARTS settings), the genotype JSON from ``--genotype-out`` read by the
  evaluation phase.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from betty_tpu_torch.examples import nas_eval as teval
from betty_tpu_torch.examples import neural_architecture_search as tnas
from betty_tpu_torch.models.darts import genotype_from_json
from torch_darts_common import equal_trees as _equal
from torch_darts_common import one_thread, run_nas_impl

ROOT = Path(__file__).resolve().parents[1]
SEARCH = ["--device", "cpu", "--batch_size", "4", "--channels", "2", "--layers", "1",
          "--train_size", "16", "--valid_step", "1000"]
EVAL = ["--device", "cpu", "--batch_size", "8", "--train_size", "24", "--init_channels", "4",
        "--layers", "2", "--auxiliary", "--cutout", "--valid_every_epochs", "10", "--epochs", "1"]


one_thread = pytest.fixture(autouse=True)(one_thread)


def test_search_matches_jax_in_float64():
    run_nas_impl("search")


def _search(argv, compiled=False):
    engine = tnas.build_engine(tnas.parse_args(SEARCH + argv + (["--compile_blocks"]
                                                                 if compiled else [])))
    engine.config.block_periods = 1
    return engine


def test_search_compiled_equals_driver_bit_for_bit():
    driver = _search(["--train_iters", "6"])
    driver.run()
    compiled = _search(["--train_iters", "6"], compiled=True)
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.periods_run >= 4
    assert driver.classifier.count == compiled.classifier.count == 6
    _equal(driver.states, compiled.states)
    assert len(driver.states["classifier"]["params"]) == 191  # one reduction cell
    assert any(not torch.equal(a, b) for a, b in zip(
        driver.states["classifier"]["extra"]["batch_stats"].values(),
        _search(["--train_iters", "6"]).states["classifier"]["extra"]["batch_stats"].values()))


def test_search_resumed_equals_uninterrupted(tmp_path):
    """Cut at 3 of 6 (cosine LR over 6) and resumed by ``auto_resume``."""
    full = _search(["--train_iters", "6"])
    full.run()
    cut = _search(["--train_iters", "6", "--checkpoint_dir", str(tmp_path),
                   "--checkpoint_step", "3"])
    cut.train_iters = 3
    cut.run()
    resumed = _search(["--train_iters", "6", "--checkpoint_dir", str(tmp_path)])
    resumed.config.auto_resume = True
    resumed.run()
    assert resumed.classifier.count == 6 and (tmp_path / "meta.json").exists()
    _equal(full.states, resumed.states)


def _jax_args(path):
    """The JAX example's ``parse_args([])``, read in a subprocess (the
    example puts its directories first on ``sys.path`` and imports
    ``main``)."""
    code = ("import importlib.util, json, sys; "
            f"spec = importlib.util.spec_from_file_location('example', {str(path)!r}); "
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod); "
            "print(json.dumps(vars(mod.parse_args([]))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("example", ["search", "eval"])
def test_cli_defaults_are_the_jax_examples(example):
    """The published DARTS settings; the port adds ``--device`` (cuda) and
    its own switches."""
    ours = vars((tnas if example == "search" else teval).parse_args([]))
    theirs = _jax_args(ROOT / "examples" / "neural_architecture_search" /
                       ("main.py" if example == "search" else "train.py"))
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    extra = {"search": {"compile_blocks", "checkpoint_dir", "checkpoint_step"},
             "eval": {"compile_blocks"}}[example]
    assert set(ours) - set(theirs) == extra | {"device"}


def test_genotype_out_feeds_the_evaluation_phase(tmp_path):
    out = tmp_path / "genotype.json"
    engine = tnas.main(SEARCH + ["--train_iters", "2", "--genotype-out", str(out)])
    genotype = genotype_from_json(out.read_text())
    assert len(genotype.normal) == len(genotype.reduce) == 8
    assert genotype == tnas.derive_genotype(engine.arch.params)
    eng = teval.main(EVAL + ["--genotype-file", str(out)])
    assert eng.network.count == 3
