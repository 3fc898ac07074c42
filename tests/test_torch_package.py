"""Boundaries of the port: it imports no JAX and nothing of betty_tpu,
options it does not port raise instead of running something else, its
entry points default to CUDA, and its loader serves the JAX loader's
batches."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu.data import ArrayLoader as JArrayLoader
from betty_tpu_torch import Config, Engine, EngineConfig
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.hypergradient import _solver, cg, neumann

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "betty_tpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_betty_tpu():
    files = sorted((ROOT / "betty_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for new in ("ops/vector.py", "ops/_build.py", "hypergradient/hvp.py", "hypergradient/cg.py",
                "hypergradient/neumann.py", "examples/logistic_regression_hpo.py"):
        assert ROOT / "betty_tpu_torch" / new in files, new
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="compile"):
        EngineConfig(compile_blocks=True)
    with pytest.raises(NotImplementedError, match="strategy"):
        EngineConfig(strategy="fsdp")
    with pytest.raises(NotImplementedError, match="remat"):
        Config(remat=True)
    assert _solver("cg") is cg and _solver("neumann") is neumann
    with pytest.raises(NotImplementedError, match="later slice"):
        _solver("reinforce")
    with pytest.raises(ValueError, match="hvp_mode"):
        Config(hvp_mode="forward")
    for flag in ("--remat", "--compile_blocks"):
        args = tex.parse_args(["--device", "cpu", "--dim", "16", "--depth", "1", "--heads",
                               "2", flag])
        with pytest.raises(NotImplementedError):
            tex.build_engine(args)


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(problems=[], config=EngineConfig(train_iters=1))
    assert tex.parse_args([]).device == "cuda"


@pytest.mark.parametrize("device", [False, "cpu"])
def test_loader_serves_the_jax_loaders_batches(device):
    x = np.arange(50 * 3).reshape(50, 3).astype(np.int32)
    y = np.arange(50).astype(np.int32)
    ours, theirs = ArrayLoader(x, y, batch_size=8, seed=4, device=device), \
        JArrayLoader(x, y, batch_size=8, seed=4)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 6
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(np.asarray(gx), np.asarray(wx))
            assert np.array_equal(np.asarray(gy), np.asarray(wy))


def test_engine_validation_cadence_and_early_stopping():
    from betty_tpu_torch import ImplicitProblem, optim
    from betty_tpu_torch.module import from_fn

    class Fit(ImplicitProblem):
        def training_step(self, batch):
            x, y = batch
            return ((self.module(x) - y) ** 2).mean()

    class ValEngine(Engine):
        seen = []

        def validation(self):
            self.seen.append(self.global_step)
            return {"loss": 1.0}  # never improves after the first

    x = np.random.RandomState(0).randn(8, 3).astype(np.float32)
    fit = Fit("fit", module=from_fn(lambda p, x: x @ p["w"], {"w": torch.zeros(3)}),
              optimizer=optim.sgd(lr=0.1), train_data_loader=[(x, x.sum(1))])
    eng = ValEngine(problems=[fit], device="cpu",
                    config=EngineConfig(train_iters=20, valid_step=2, early_stopping=True,
                                        early_stopping_tolerance=2))
    eng.run()
    assert eng.seen == [2, 4, 6] and eng.global_step == 6 and fit.count == 6
    assert float(eng.states["fit"]["params"]["w"].abs().sum()) > 0
