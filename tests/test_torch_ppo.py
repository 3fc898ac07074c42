"""PPO: the port's ``examples/ppo.py`` and ``rl/buffer.py`` against the JAX
package's.

* The program at ``tests/test_examples2.py``'s arguments (4 envs, horizon
  32, 8 iterations, a rollout every 4) in float64 from the same weights:
  both problems' parameters within 1e-8, the last rollout's actions equal
  and its advantages and returns within 1e-8, counts 8:8, ``mean_return``
  equal (``torch_pruning_impl.py ppo``, in a subprocess).
* ``ExperienceBuffer``: ``tests/test_examples2.py``'s case, and the same
  minibatches as JAX's buffer for an explicit seed and for the epoch-seeded
  default, with and without ``drop_last``.
* ``VecCartPole``'s trajectories, ``PPOEnv``'s minibatch rows and the
  port's own rollouts' invariants; the actor has no hypergradient path and
  is the critic's parent; compiled blocks run this engine (it overrides
  ``train_step``) in driver mode; the CLI's defaults are the JAX example's.
"""

import importlib.util
from pathlib import Path
import sys

import numpy as np
import pytest

from betty_tpu.rl import ExperienceBuffer as JBuffer
from betty_tpu_torch.examples import ppo as tppo
from betty_tpu_torch.rl import ExperienceBuffer
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--n_envs", "4", "--horizon", "32", "--train_iters", "8",
         "--epochs_per_rollout", "4"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _jax_example():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("ppo_main", ROOT / "examples" / "ppo" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_matches_jax_in_float64():
    lines = run_robust_impl(("ppo",), script="torch_pruning_impl.py")["ppo"]
    assert len(lines) == 1 and lines[0].startswith("OK "), lines


def test_experience_buffer():
    buf = ExperienceBuffer()
    for t in range(10):
        buf.add(obs=np.full((4,), t, np.float32), rew=float(t))
    assert len(buf) == 10
    data = buf.stacked()
    assert data["obs"].shape == (10, 4)
    batches = list(buf.batches(4, shuffle=True, seed=0))
    assert len(batches) == 2 and batches[0]["obs"].shape == (4, 4)
    buf.clear()
    assert len(buf) == 0


@pytest.mark.parametrize("seed,drop_last", [(0, True), (None, True), (None, False), (7, False)])
def test_buffer_batches_equal_jax(seed, drop_last):
    ours, theirs = ExperienceBuffer(), JBuffer()
    rng = np.random.RandomState(1)
    for _ in range(11):
        fields = {"obs": rng.randn(3).astype(np.float32), "act": rng.randint(2)}
        ours.add(**fields)
        theirs.add(**fields)
    for _ in range(3):  # the default stream moves on every call
        got = list(ours.batches(4, seed=seed, drop_last=drop_last))
        want = list(theirs.batches(4, seed=seed, drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    ours.clear()
    theirs.clear()
    assert len(ours) == len(theirs) == 0


def test_cartpole_trajectories_equal_jax():
    jmod = _jax_example()
    ours, theirs = tppo.VecCartPole(6, seed=3), jmod.VecCartPole(6, seed=3)
    rng = np.random.RandomState(0)
    resets = 0
    for _ in range(300):
        actions = rng.randint(0, 2, 6)
        (s1, r1, d1), (s2, r2, d2) = ours.step(actions), theirs.step(actions)
        for a, b in ((s1, s2), (r1, r2), (d1, d2), (ours.steps, theirs.steps)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        resets += int(d1.sum())
    assert resets > 0  # episodes ended and the simulator reset them


def test_rollouts_and_minibatches():
    engine = tppo.build_engine(tppo.parse_args(SMALL))
    env = engine.env
    env.step()
    roll = env.rollout
    assert roll["obs"].shape == (128, 4) and roll["act"].shape == (128,)
    assert all(v.dtype == np.float32 for k, v in roll.items() if k != "act")
    assert abs(float(roll["adv"].mean())) < 1e-5 and abs(float(roll["adv"].std()) - 1) < 1e-3
    batch = env.minibatch(256, 3)
    idx = np.random.RandomState(3).randint(0, 128, 256)
    for k, v in batch.items():
        np.testing.assert_array_equal(v, roll[k][idx])
    assert engine.actor.paths == [] and engine.critic.parents == [engine.actor]
    assert engine.leaves == [engine.critic]


def test_compiled_blocks_run_this_engine_in_driver_mode():
    driver = tppo.build_engine(tppo.parse_args(SMALL))
    driver.run()
    compiled = tppo.build_engine(tppo.parse_args(SMALL))
    compiled.config.compile_blocks = True
    compiled.run()
    assert compiled.block_runner is None
    assert (compiled.actor.count, compiled.critic.count) == (8, 8)
    np.testing.assert_array_equal(compiled.env.rollout["act"], driver.env.rollout["act"])
    equal_trees(driver.states, compiled.states)


def test_cli_defaults_are_the_jax_example():
    ours = vars(tppo.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "ppo" / "main.py")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device"}
