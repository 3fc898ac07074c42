"""Implicit MAML: the port's ``examples/implicit_maml.py``,
``models/omniglot.py`` and ``envs/`` against the JAX package's.

* ``OmniglotCNN`` against flax's (train-mode logits and new BatchNorm
  statistics, eval-mode logits; float32 within 1e-5, float64 within
  1e-10); the iMAML program at ``tests/test_examples.py``'s arguments in
  float64 from the same weights: parameters within 1e-8, counts inner 8
  and meta 4, an accumulation boundary at the end; and the program on a
  synthetic Omniglot npz with ``meta_test_acc`` equal to JAX's
  (``torch_programs_impl.py omniglot imaml imaml_pool``, in a
  subprocess).
* The VALID max pool: 28 -> 14 -> 7 -> 3 -> 1, values equal to flax's;
  SAME stays the default.
* ``MAMLEnv``'s and ``sample_task_from_pool``'s arrays equal JAX's after
  several steps; ``load_omniglot`` and ``split_omniglot_pools`` equal
  JAX's on the same npz.
* The env gets the engine's device before ``initialize``; the warm start
  copies the meta weights; compiled blocks run this engine (it overrides
  ``train_step``) in driver mode; the CLI's defaults are the JAX
  example's.
"""

import importlib.util
from pathlib import Path
import sys

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu_torch.envs import Env
from betty_tpu_torch.examples import implicit_maml as timaml
from betty_tpu_torch.examples import vision_data as tvision
from betty_tpu_torch.models.layers import max_pool
from torch_darts_common import (equal_trees, jax_cli_defaults, one_thread, run_robust_impl,
                                write_pool)

ROOT = Path(__file__).resolve().parents[1]
CASES = ("omniglot", "imaml", "imaml_pool")
SMALL = ["--device", "cpu", "--ways", "3", "--inner_steps", "2", "--meta_batch_size", "2",
         "--train_iters", "8"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _jax_example():
    sys.path.insert(0, str(ROOT / "examples"))
    spec = importlib.util.spec_from_file_location("imaml_main",
                                                  ROOT / "examples" / "implicit_maml" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def imaml_runs():
    return run_robust_impl(CASES, script="torch_programs_impl.py")


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(imaml_runs, case):
    lines = imaml_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def test_valid_max_pool_matches_flax():
    x = np.random.RandomState(0).randn(2, 28, 28, 3).astype(np.float32)
    got, want = torch.tensor(x).permute(0, 3, 1, 2), jnp.asarray(x)
    for side in (14, 7, 3, 1):
        got = max_pool(got, 2, 2, padding="VALID")
        want = nn.max_pool(want, (2, 2), strides=(2, 2))  # flax's default: VALID
        assert got.shape == (2, 3, side, side)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    same = max_pool(torch.tensor(x).permute(0, 3, 1, 2)[:, :, :7, :7], 2, 2)
    assert same.shape == (2, 3, 4, 4)  # SAME stays the default (DARTS's pools)


@pytest.mark.parametrize("pool", [False, True])
def test_env_streams_match_jax(pool, tmp_path):
    jmod = _jax_example()
    kw = dict(ways=4, shots=2, seed=3)
    if pool:
        path = str(tmp_path / "omniglot.npz")
        write_pool(path)
        jpool, _ = jmod.split_omniglot_pools(path)
        tpool, _ = timaml.split_omniglot_pools(path)
        kw_j, kw_t = dict(kw, pool=jpool), dict(kw, pool=tpool)
    else:
        kw_j = kw_t = kw
    jenv, tenv = jmod.MAMLEnv(**kw_j), timaml.MAMLEnv(**kw_t)
    for _ in range(4):
        for (jx, jy), (tx, ty) in ((jenv.support, tenv.support), (jenv.query, tenv.query)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tx.dtype == np.float32 and ty.dtype == np.int64
        jenv.step()
        tenv.step()


def test_omniglot_loading_matches_jax(tmp_path):
    jmod = _jax_example()
    from vision_data import load_omniglot

    path = str(tmp_path / "omniglot.npz")
    write_pool(path)
    (jx, jy), (tx, ty) = load_omniglot(path), tvision.load_omniglot(path)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tx.shape[1:] == (28, 28, 1) and tx.max() <= 1.0
    for jpool, tpool in zip(jmod.split_omniglot_pools(path), timaml.split_omniglot_pools(path)):
        np.testing.assert_array_equal(tpool[2], jpool[2])  # the same classes on each side


def test_env_configured_with_the_engine_device():
    from betty_tpu_torch import Engine, EngineConfig, ImplicitProblem, optim
    from betty_tpu_torch.module import from_fn

    seen = []

    class Probe(Env):
        def initialize(self):
            seen.append((self.device, self.engine))

    class Fit(ImplicitProblem):
        def training_step(self, batch):
            return (self.module() ** 2).sum()

        def get_batch(self):
            return ()

    fit = Fit("fit", module=from_fn(lambda p: p["w"], {"w": torch.ones(2)}),
              optimizer=optim.sgd(lr=0.1))
    probe = Probe()
    engine = Engine(problems=[fit], config=EngineConfig(train_iters=1), env=probe, device="cpu")
    assert seen == [(torch.device("cpu"), engine)]
    assert probe.fit is fit and fit.env is probe
    maml = timaml.build_engine(timaml.parse_args(SMALL))
    assert maml.env.device == torch.device("cpu") and maml.env.inner is maml.inner


def test_warm_start_copies_the_meta_weights():
    engine = timaml.build_engine(timaml.parse_args(SMALL))
    engine.inner.on_inner_loop_start()
    inner, meta = engine.states["inner"]["params"], engine.states["meta"]["params"]
    for k in meta:
        assert torch.equal(inner[k], meta[k])
        assert inner[k].data_ptr() != meta[k].data_ptr()


def test_compiled_blocks_run_this_engine_in_driver_mode():
    driver = timaml.build_engine(timaml.parse_args(SMALL))
    driver.run()
    compiled = timaml.build_engine(timaml.parse_args(SMALL))
    compiled.config.compile_blocks = True
    compiled.run()
    assert compiled.block_runner is None
    assert (compiled.inner.count, compiled.meta.count) == (8, 4)
    np.testing.assert_array_equal(compiled.env.support[0], driver.env.support[0])
    equal_trees(driver.states, compiled.states)


def test_cli_defaults_are_the_jax_example():
    ours = vars(timaml.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "implicit_maml" / "main.py")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device"}
