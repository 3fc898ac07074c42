"""The Meta-Weight-Net slice: the port's ``examples/learning_to_reweight``
against the JAX package's ``examples/learning_to_reweight/main.py``.

* The whole program (darts, SAMA, CG, Neumann, ``--baseline``,
  ``--retrain``, and iterative differentiation through the classifier's
  step, ``itd``) from the same weights on the same batches, in float64
  (``torch_mwn_impl.py``, in a subprocess): after 4 + 4 steps both
  problems' params and batch_stats within 1e-8 (measured 3.4e-10).
* The data path: the same splits, corruptions, crops and loaded arrays
  as the JAX example's numpy code, element for element.
* ``export_sample_weights`` and ``--retrain``, the schedules, validation
  accuracy and ``entry()``, in float32.
"""

import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu import optim as joptim
from betty_tpu.models import ResNet as JResNet
from betty_tpu_torch import convert
from betty_tpu_torch import optim as toptim
from betty_tpu_torch.examples import learning_to_reweight as tex
from betty_tpu_torch.examples import mwn_data as tdata
from betty_tpu_torch.examples import vision_data as tvision

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--batch_size", "8", "--train_size", "64", "--meta_size", "32"]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "mwn_torch_test", ROOT / "examples" / "learning_to_reweight" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mwn_torch_test"] = mod
    spec.loader.exec_module(mod)
    mod.ResNet32 = lambda n: JResNet(stage_sizes=(1, 1, 1), num_classes=n)
    return mod


@pytest.fixture(scope="module")
def jmod():
    return _jax_example()


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load_jax_states(jeng, teng):
    """Put the JAX engine's classifier (and reweighter) state into the port's."""
    c = jeng.states["classifier"]
    params, stats = convert.from_flax_resnet(
        _numpy({"params": c["params"], "batch_stats": c["extra"]["batch_stats"]}))
    teng.states["classifier"]["params"] = params
    teng.states["classifier"]["extra"] = {"batch_stats": stats}
    if "reweight" in jeng.states:
        teng.states["reweight"]["params"] = convert.from_flax_mwn(
            _numpy(jeng.states["reweight"]["params"]))


CASES = ("darts", "sama", "cg", "neumann", "baseline", "retrain", "itd")


@pytest.fixture(scope="module")
def float64_runs():
    """Every case of ``torch_mwn_impl.py`` in one subprocess (about a
    minute: JAX's start-up and compilation are paid once), on few threads,
    since the test workers share the machine's cores."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    result = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mwn_impl.py"), *CASES],
                            capture_output=True, text=True, env=env, timeout=900)
    return result


@pytest.mark.parametrize("case", CASES)
def test_mwn_program_matches_jax_in_float64(float64_runs, case):
    lines = [line for line in float64_runs.stdout.splitlines()
             if f'"case": "{case}"' in line]
    print(float64_runs.stdout)
    print(float64_runs.stderr[-3000:], file=sys.stderr)
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


@pytest.mark.parametrize("corruption", [None, "uniform", "flip1", "flip2"])
def test_splits_and_corruption_match_jax(jmod, corruption):
    import mwn_data as jdata  # the JAX example's, on the path its main.py set

    rng = np.random.RandomState(0)
    x = rng.rand(600, 4, 4, 3).astype(np.float32)
    y = rng.randint(0, 10, 600).astype(np.int32)
    kw = dict(num_classes=10, num_meta_total=100, imbalanced_factor=10,
              corruption_type=corruption, corruption_ratio=0.4, seed=3, return_indices=True)
    got, want = tdata.build_splits(x, y, **kw), jdata.build_splits(x, y, **kw)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    labels = rng.randint(0, 10, 300).astype(np.int32)
    got = tdata.corrupt_labels(labels, corruption, 0.5, 10, np.random.RandomState(5))
    want = jdata.corrupt_labels(labels, corruption, 0.5, 10, np.random.RandomState(5))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    if corruption is not None:
        assert got[1].any()


def test_augment_serves_the_jax_batches(jmod):
    rng = np.random.RandomState(0)
    x = rng.randn(40, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 40).astype(np.int32)
    ours = tex.BatchLoader(x, y, 8, seed=2, augment=True)
    theirs = jmod.BatchLoader(x, y, 8, seed=2, augment=True)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 5
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, np.asarray(wx)) and np.array_equal(gy, np.asarray(wy))
    assert not np.array_equal(got[0][0], x[np.random.RandomState(3).permutation(40)[:8]])
    with pytest.raises(ValueError, match="host"):
        tex.BatchLoader(x, y, 8, device="cpu", augment=True)


@pytest.mark.parametrize("layout", ["npz", "pickle"])
def test_load_classification_matches_jax(jmod, tmp_path, layout):
    import vision_data as jvision

    rng = np.random.RandomState(0)
    if layout == "npz":
        path = tmp_path / "cifar.npz"
        np.savez(path, x_train=rng.randint(0, 256, (20, 32, 32, 3)).astype(np.uint8),
                 y_train=rng.randint(0, 10, 20), x_test=rng.randint(0, 256, (6, 32, 32, 3)),
                 y_test=rng.randint(0, 10, 6))
    else:
        path = tmp_path / "cifar-10-batches-py"
        path.mkdir()
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            with open(path / name, "wb") as f:
                pickle.dump({b"data": rng.randint(0, 256, (4, 3 * 32 * 32)).astype(np.uint8),
                             b"labels": list(rng.randint(0, 10, 4))}, f)
        path = tmp_path
    got, want = tvision.load_classification(str(path)), jvision.load_classification(str(path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape == (20, 32, 32, 3) and got[0].dtype == np.float32


def test_validation_accuracy_matches_jax(jmod, tmp_path):
    """``--data-dir`` through ``build_splits``: the same kept set, and the
    same test accuracy from the same weights (eval mode)."""
    rng = np.random.RandomState(1)
    path = tmp_path / "cifar.npz"
    np.savez(path, x_train=rng.randint(0, 256, (200, 32, 32, 3)).astype(np.uint8),
             y_train=rng.randint(0, 10, 200), x_test=rng.randint(0, 256, (37, 32, 32, 3)),
             y_test=rng.randint(0, 10, 37))
    argv = ["--batch_size", "8", "--data-dir", str(path), "--num_meta", "20",
            "--imbalanced_factor", "5", "--corruption_type", "flip1", "--corruption_ratio", "0.3"]
    jeng = jmod.build_engine(jmod.parse_args(argv))
    teng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu", "--stage_sizes", "1,1,1"]))
    for a, b in zip(teng.train_set, jeng.train_set):
        assert np.array_equal(a, b)
    _load_jax_states(jeng, teng)
    jeng.eval_batch = teng.eval_batch = 16  # a padded tail: 37 = 2 x 16 + 5
    for eng in (jeng, teng):
        eng.eval()
    got, want = teng.validation(), jeng.validation()
    assert got["acc"] == want["acc"] and 0 < got["acc"] < 100


def test_export_weights_and_retrain_round_trip(jmod, tmp_path):
    """The reweighter's exported per-example weights (eval mode, a ragged
    last batch) agree with the JAX example's from the same state; the
    port's ``--retrain`` then samples the kept set as the JAX loader does."""
    argv = SMALL + ["--train_iters", "2"]
    jeng = jmod.build_engine(jmod.parse_args(argv))
    jeng.run()
    teng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu", "--stage_sizes", "1,1,1"]))
    _load_jax_states(jeng, teng)
    paths = {"port": tmp_path / "port.npz", "jax": tmp_path / "jax.npz"}
    tex.export_sample_weights(teng, paths["port"], batch=24)
    jmod.export_sample_weights(jeng, paths["jax"], batch=24)
    got, want = np.load(paths["port"]), np.load(paths["jax"])
    assert np.array_equal(got["indexes"], want["indexes"])
    assert np.array_equal(got["labels"], want["labels"])
    assert got["weights"].shape == (64,)
    assert np.abs(got["weights"] - want["weights"]).max() <= 1e-5
    assert teng.classifier._training and teng.reweight._training

    argv = SMALL + ["--retrain", "--reweight_path", str(paths["port"]), "--train_iters", "2"]
    treng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu", "--stage_sizes", "1,1,1"]))
    jreng = jmod.build_engine(jmod.parse_args(argv))
    assert list(treng.states) == ["classifier"]
    ours, theirs = treng.classifier.train_data_loader[0], jreng.classifier.train_data_loader[0]
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for (gx, gy), (wx, wy) in zip(ours, theirs):
            assert np.array_equal(gx, np.asarray(wx)) and np.array_equal(gy, np.asarray(wy))
    before = {k: t.clone() for k, t in treng.states["classifier"]["params"].items()}
    treng.run()
    assert treng.classifier.count == 2
    assert any(not torch.equal(before[k], t)
               for k, t in treng.states["classifier"]["params"].items())


SCHEDULES = {
    "step": lambda m: m.step_lr(0.1, step_size=3, gamma=0.5),
    "cosine": lambda m: m.cosine_lr(0.1, total_steps=7, min_lr=0.01),
    "lambda": lambda m: m.lambda_lr(0.1, lambda s: 1.0 / (1 + s)),
    "multistep": lambda m: m.multistep_lr(0.1, [2, 5], gamma=0.1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_betty_tpu(name):
    ours, theirs = SCHEDULES[name](toptim), SCHEDULES[name](joptim)
    for step in range(10):
        want = float(theirs(jnp.asarray(step)))
        assert abs(ours(step) - want) <= 1e-6 * abs(want), (step, ours(step), want)


def test_make_schedule_milestones(jmod):
    args = tex.parse_args(["--lr_milestones", "3,6"])
    sched = tex.make_schedule(args)
    want = jmod.make_schedule(jmod.parse_args(["--lr_milestones", "3,6"]))
    assert [round(sched(s), 8) for s in (0, 3, 6)] == [0.1, 0.01, 0.001]
    assert all(abs(sched(s) - float(want(s))) <= 1e-8 for s in range(8))
    assert tex.make_schedule(tex.parse_args([])) is None


def test_entry_matches_graft_entry():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as graft
    from betty_tpu_torch.entry import entry

    jstep, (rv, mv, images, labels) = graft.entry()
    step, (rvars, mvars, timages, tlabels) = entry(device="cpu")
    assert tuple(timages.shape) == images.shape and tuple(tlabels.shape) == labels.shape
    params, stats = convert.from_flax_resnet(_numpy(rv))
    rvars = {"params": params, "batch_stats": stats}
    mvars = {"params": convert.from_flax_mwn(_numpy(mv["params"]))}
    rng = np.random.RandomState(0)
    batches = [(np.asarray(images), np.asarray(labels)),
               (rng.randn(*images.shape).astype(np.float32),
                rng.randint(0, 10, labels.shape).astype(np.int32))]
    for x, y in batches:
        want = float(jstep(rv, mv, jnp.asarray(x), jnp.asarray(y)))
        got = float(step(rvars, mvars, torch.tensor(x), torch.tensor(y, dtype=torch.int64)))
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
