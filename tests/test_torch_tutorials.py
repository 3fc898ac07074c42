"""The port's tutorials (``betty_tpu_torch/tutorial/``) against the JAX
package's (``tutorial/``).

* ``make_imbalanced_mnist``: the arrays equal JAX's ``tutorial/common.py``'s
  (loaded by path), dtypes included; the module builders' shapes.
* Tutorials 1 (and ``--baseline``), 2, 3, 4, 6 (driver mode, compiled with
  host data, compiled with device data) and 8 at a few iterations from the
  JAX tutorials' own weights (``torch_tutorials_impl.py``, in a subprocess):
  float64 parameters within 1e-10, tutorial 2's validation accuracy equal,
  tutorial 8's printed norm within 1e-10, and tutorial 4's (bf16 steps)
  fixed-batch losses, evaluated in float32 at either side's final
  parameters, within 2e-2 relative.
* Each tutorial's defaults are the JAX tutorial's, with ``--device cuda``.
"""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu_torch.tutorial import common

ROOT = Path(__file__).resolve().parents[1]
CASES = ("t1", "t1_baseline", "t2", "t3", "t4", "t6_0", "t6_1", "t6_2", "t8")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_common():
    spec = importlib.util.spec_from_file_location("jax_tutorial_common",
                                                  ROOT / "tutorial" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [{}, {"n": 256, "imbalance": 1, "seed": 1},
                                {"n": 512, "imbalance": 1, "seed": 2}, {"n": 100, "seed": 7}])
def test_make_imbalanced_mnist_matches_jax(kw):
    jcommon = _jax_common()
    got, want = common.make_imbalanced_mnist(**kw), jcommon.make_imbalanced_mnist(**kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(common._PROTOS, jcommon._PROTOS)


def test_module_builders():
    clf = common.classifier_module(128, device="cpu").variables["params"]
    rw = common.reweight_module(128, device="cpu").variables["params"]
    assert {k: tuple(v.shape) for k, v in clf.items()} == {
        "layers.0.weight": (128, 784), "layers.0.bias": (128,), "layers.1.weight": (2, 128),
        "layers.1.bias": (2,)}
    assert {k: tuple(v.shape) for k, v in rw.items()} == {
        "layers.0.weight": (100, 1), "layers.0.bias": (100,), "layers.1.weight": (1, 100),
        "layers.1.bias": (1,)}
    again = common.classifier_module(64, device="cpu").variables["params"]
    other = common.classifier_module(128, rng_seed=3, device="cpu").variables["params"]
    assert all(np.array_equal(clf[k].numpy(), again[k].numpy()) for k in clf)
    assert not np.array_equal(clf["layers.0.weight"].numpy(), other["layers.0.weight"].numpy())


@pytest.fixture(scope="module")
def float64_runs():
    """Every case of ``torch_tutorials_impl.py`` in one subprocess, on few
    threads, since the test workers share the machine's cores."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    return subprocess.run([sys.executable, str(ROOT / "tests" / "torch_tutorials_impl.py"),
                           *CASES], capture_output=True, text=True, env=env, timeout=900)


@pytest.mark.parametrize("case", CASES)
def test_tutorial_matches_jax(float64_runs, case):
    lines = [line for line in float64_runs.stdout.splitlines() if f'"case": "{case}"' in line]
    print(float64_runs.stdout[-20000:])
    print(float64_runs.stderr[-3000:], file=sys.stderr)
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


@pytest.mark.parametrize("name,argv,want", [
    ("1_quick_start", [], {"baseline": False, "train_iters": 3000, "batch_size": 128}),
    ("2_validation", [], {"train_iters": 3000, "valid_step": 500}),
    ("3_logging", [], {"train_iters": 1000}),
    ("4_memory_optimization", [], {"train_iters": 2000}),
    ("6_performance", [], {"train_iters": 512}),
    ("8_custom_solver", [], {"train_iters": 100}),
])
def test_tutorial_defaults(name, argv, want):
    mod = importlib.import_module(f"betty_tpu_torch.tutorial.{name}")
    args = vars(mod.parse_args(argv))
    assert args.pop("device") == "cuda"
    assert args == want


def test_tutorial_configurations_on_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # tutorial 3's TensorBoard sink writes here
    t3 = importlib.import_module("betty_tpu_torch.tutorial.3_logging")
    t4 = importlib.import_module("betty_tpu_torch.tutorial.4_memory_optimization")
    t6 = importlib.import_module("betty_tpu_torch.tutorial.6_performance")
    t8 = importlib.import_module("betty_tpu_torch.tutorial.8_custom_solver")
    e4 = t4.build_engine(t4.parse_args(["--device", "cpu"]))
    assert (e4.classifier.config.precision, e4.classifier.config.gradient_accumulation,
            e4.reweight.config.precision) == ("bf16", 2, "bf16")
    assert [c for _, c in t6.CONFIGS] == [(False, False, "fp32"), (True, False, "fp32"),
                                          (True, True, "fp32"), (True, True, "bf16")]
    e6 = t6.build(True, True, "bf16", device="cpu")
    assert e6.config.compile_blocks and e6.classifier.train_data_loader[0].device.type == "cpu"
    e8 = t8.build_engine(t8.parse_args(["--device", "cpu"]))
    from betty_tpu_torch.hypergradient import _solver

    assert e8.classifier.config.type == "t1t2" and _solver("t1t2") is t8.t1t2
    assert t3.build_engine(t3.parse_args(["--device", "cpu"])).config.logger_type == "tensorboard"
