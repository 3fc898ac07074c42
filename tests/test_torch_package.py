"""Boundaries of the port: it imports no JAX and nothing of betty_tpu,
options it does not port raise instead of running something else (and the
ported ones are accepted), its
entry points default to CUDA, and its loader serves the JAX loader's
batches."""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu.data import ArrayLoader as JArrayLoader
from betty_tpu_torch import Config, Engine, EngineConfig
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.entry import entry
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.examples import learning_to_reweight as mwn
from betty_tpu_torch.examples import nas_eval, neural_architecture_search as nas
from betty_tpu_torch.examples import robust_nas, saliency_aware_nas_4_level as sanas
from betty_tpu_torch.examples import implicit_maml, learning_by_ignoring as lbi
from betty_tpu_torch.examples import nas_augmented_image_captioning_3_level as iuc
from betty_tpu_torch.examples import imagenet_pruning, moe_reweighting, ppo
from betty_tpu_torch import test_install
from betty_tpu_torch.hypergradient import _solver, cg, neumann, reinforce

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "betty_tpu", "examples", "mwn_data", "vision_data",
             "common")
TUTORIALS = ("1_quick_start", "2_validation", "3_logging", "4_memory_optimization",
             "5_distributed_training", "6_performance", "7_model_parallelism",
             "8_custom_solver")


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
                "hypergradient/neumann.py", "examples/logistic_regression_hpo.py",
                "models/batchnorm.py", "models/resnet.py", "examples/learning_to_reweight.py",
                "examples/mwn_data.py", "examples/vision_data.py", "entry.py", "compile.py",
                "problems/iterative.py", "hypergradient/reinforce.py", "checkpoint.py",
                "models/darts.py", "models/layers.py", "examples/neural_architecture_search.py",
                "examples/nas_eval.py", "models/mlp.py", "examples/robust_nas.py",
                "examples/saliency_aware_nas_4_level.py", "models/iuc.py", "models/omniglot.py",
                "envs/__init__.py", "envs/env_base.py", "examples/learning_by_ignoring.py",
                "examples/nas_augmented_image_captioning_3_level.py",
                "examples/implicit_maml.py", "data/augment.py", "examples/imagenet_pruning.py",
                "rl/__init__.py", "rl/buffer.py", "examples/ppo.py", "models/moe.py",
                "examples/moe_reweighting.py", "logging/logger_tensorboard.py",
                "logging/logger_wandb.py", "test_install.py", "tutorial/__init__.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                "tutorial/common.py", *(f"tutorial/{t}.py" for t in TUTORIALS)):
        assert ROOT / "betty_tpu_torch" / new in files, new
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_unported_options_raise(monkeypatch):
    assert EngineConfig(compile_blocks=True).compile_blocks  # ported: accepted
    # ported: the data-parallel strategies, tensor, expert, pipeline and
    # sequence parallelism, the dp x mdl x pp composition and meshes of three
    # and four model axes; a malformed mesh raises
    for s in ("dp", "distributed", "zero", "fsdp", "tp", "ep", "pp", "sp"):
        assert EngineConfig(strategy=s).strategy == s
    assert EngineConfig(strategy="tp", mesh_shape=(("dp", 1), ("mdl", 2))).strategy == "tp"
    for s, axis in (("pp", "pp"), ("sp", "sp"), ("dp", "pp"), ("dp", "sp")):
        assert EngineConfig(strategy=s, mesh_shape=(("dp", 1), (axis, 2))).mesh_shape[1][0] == axis
    assert EngineConfig(strategy="tp", mesh_shape=(("dp", 1), ("mdl", 2), ("pp", 2))).strategy \
        == "tp"
    four = (("dp", 1), ("mdl", 2), ("pp", 2), ("sp", 2), ("ep", 2))
    assert EngineConfig(strategy="tp", mesh_shape=four[:4]).mesh_shape == four[:4]
    assert EngineConfig(strategy="tp", mesh_shape=four).mesh_shape == four
    with pytest.raises(ValueError, match="different model axes"):
        EngineConfig(strategy="tp", mesh_shape=four + (("mdl", 2),))
    # ported: parameter groups build a grouped optimizer
    from betty_tpu_torch import optim

    engine = lbi.build_engine(lbi.parse_args(["--device", "cpu", "--train_iters", "1"]))
    assert isinstance(engine.finetune.optimizer, optim.GroupedOptimizer)
    # ported: rematerialization and engine checkpoints are accepted
    assert Config(remat=True).remat
    cfg = EngineConfig(checkpoint_step=5, checkpoint_dir="ckpt", auto_resume=True)
    assert (cfg.checkpoint_step, cfg.auto_resume) == (5, True)
    assert _solver("cg") is cg and _solver("neumann") is neumann
    assert _solver("reinforce") is reinforce  # ported
    with pytest.raises(ValueError, match="hvp_mode"):
        Config(hvp_mode="forward")
    small = ["--device", "cpu", "--dim", "16", "--depth", "1", "--heads", "2"]
    built = []

    class Recorded(tex.TransformerClassifier):
        def __init__(self, **kw):
            super().__init__(**kw)
            built.append((self.remat, self.remat_policy))

    monkeypatch.setattr(tex, "TransformerClassifier", Recorded)
    for policy in ("full", "minimal", "dots"):
        tex.build_engine(tex.parse_args(small + ["--flash", "--remat", "--remat_policy", policy]))
    assert built == [(True, None), (True, "minimal"), (True, "dots")]
    args = mwn.parse_args(["--device", "cpu", "--stage_sizes", "1,1,1",
                           "--checkpoint_dir", "ckpt"])
    assert mwn.build_engine(args).checkpoint_dir == "ckpt"
    assert tex.build_engine(tex.parse_args(small + ["--checkpoint_dir", "ckpt"])) \
        .checkpoint_dir == "ckpt"
    # tp is ported, but needs a model axis on the mesh, which this example
    # does not lay out
    args = mwn.parse_args(["--device", "cpu", "--stage_sizes", "1,1,1", "--strategy", "tp"])
    with pytest.raises(ValueError, match="model axis"):
        mwn.build_engine(args)
    # compiled blocks are ported: both examples build an engine with them
    assert tex.build_engine(tex.parse_args(small + ["--compile_blocks"])).config.compile_blocks
    assert mwn.build_engine(mwn.parse_args(["--device", "cpu", "--stage_sizes", "1,1,1",
                                            "--compile_blocks"])).config.compile_blocks


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(problems=[], config=EngineConfig(train_iters=1))
    assert tex.parse_args([]).device == "cuda"
    assert mwn.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mwn.build_engine(mwn.parse_args(["--stage_sizes", "1,1,1", "--train_size", "8",
                                         "--meta_size", "8", "--batch_size", "4"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    assert nas.parse_args([]).device == nas_eval.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nas.build_engine(nas.parse_args(["--channels", "2", "--layers", "1", "--batch_size", "4",
                                         "--train_size", "8"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nas_eval.build_engine(nas_eval.parse_args(["--init_channels", "2", "--layers", "2",
                                                   "--batch_size", "4", "--train_size", "8"]))
    assert robust_nas.parse_args([]).device == sanas.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robust_nas.build_engine(robust_nas.parse_args(["--arch", "mlp"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sanas.build_engine(sanas.parse_args([]))
    for example in (lbi, iuc, implicit_maml, imagenet_pruning, ppo, moe_reweighting):
        assert example.parse_args([]).device == "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.build_engine(example.parse_args([]))
    assert inspect.signature(test_install.main).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_install.main(train_iters=1)
    for name in TUTORIALS:
        tutorial = importlib.import_module(f"betty_tpu_torch.tutorial.{name}")
        assert tutorial.parse_args([]).device == "cuda"
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tutorial.main([])


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
