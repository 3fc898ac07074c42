"""``betty_tpu_torch.test_install``, ``data.prefetch_to_device`` and the
tree utilities ``count_parameters``, ``to_vec``, ``tree_sub`` and
``tree_where_mask`` against the JAX package's.

* ``test_install.main`` on the CPU at its defaults (2,000 iterations: the
  outer loss below 0.48 and the Hello line), and at 200 iterations the
  final outer loss against JAX's within 1e-5 (float32 both).
* ``prefetch_to_device`` yields the iterator's batches in order, the last
  ones included, for sizes 1 to 3 and an iterator shorter than ``size``,
  keeps ``size`` batches drawn ahead, and matches JAX's.
* The four utilities on the same trees (leaf order: the port's dicts in
  insertion order, JAX's sorted, so the trees here are built sorted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betty_tpu.engine as jengine
from betty_tpu import test_install as jinstall
from betty_tpu import utils as jutils
from betty_tpu.data.loader import prefetch_to_device as jprefetch
from betty_tpu_torch import test_install, utils
from betty_tpu_torch.data import prefetch_to_device


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_install_check_passes_on_cpu(capsys):
    loss = test_install.main(device="cpu")
    assert loss < 0.48
    out = capsys.readouterr().out
    assert f"Hello (Betty-TPU) World — install OK, final outer loss {loss:.4f}" in out


def test_install_loss_matches_jax_at_200_iterations(monkeypatch):
    engines = []
    orig = jengine.Engine.run

    def recorded(self):
        engines.append(self)
        return orig(self)

    monkeypatch.setattr(jengine.Engine, "run", recorded)
    try:
        jinstall.main(train_iters=200)
    except AssertionError:  # JAX's check asserts < 0.48, which 200 iterations may not reach
        pass
    jeng, = engines
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in jeng.states.items()}
    want = float(jeng.outer.eval_loss(ctx, jeng.outer.cur_batch)[0])
    engine, outer = test_install.build_engine(train_iters=200, device="cpu")
    engine.run()
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    got = float(outer.eval_loss(ctx, outer.cur_batch)[0])
    assert [p.count for p in engine.problems] == [p.count for p in jeng.problems] == [2, 200]
    assert abs(got - want) <= 1e-5, (got, want)


def test_install_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_install.build_engine(train_iters=1)


def _source(n, pulled, leaf=torch.tensor):
    for i in range(n):
        pulled.append(i)
        yield (np.full((2, 3), i, np.float32), leaf([i, -i]), {"i": i})


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_prefetch_yields_every_batch_in_order(size, n):
    pulled, ahead = [], []
    out = []
    for batch in prefetch_to_device(_source(n, pulled), size=size, device="cpu"):
        ahead.append(len(pulled))
        out.append(batch)
    assert [b[2]["i"] for b in out] == list(range(n))
    assert ahead == [min(n, size + k) for k in range(n)]  # size batches drawn ahead
    for i, (x, t, _) in enumerate(out):
        assert isinstance(x, np.ndarray) and np.array_equal(x, np.full((2, 3), i, np.float32))
        assert torch.equal(t, torch.tensor([i, -i]))
    want = list(jprefetch(_source(n, [], np.array), size=size))
    assert len(want) == n
    for (x, t, d), (jx, jt, jd) in zip(out, want):
        assert np.array_equal(x, np.asarray(jx)) and np.array_equal(t.numpy(), np.asarray(jt))
        assert d == {"i": int(jd["i"])}


def test_prefetch_checks_its_arguments():
    with pytest.raises(ValueError, match="size"):
        prefetch_to_device([1], size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prefetch_to_device([1])


def _trees(seed=0):
    rng = np.random.RandomState(seed)

    def draw(*shape):
        return rng.randn(*shape).astype(np.float32)

    a = {"b": draw(3), "w": {"k": draw(2, 4), "v": draw(5)}}
    b = {"b": draw(3), "w": {"k": draw(2, 4), "v": draw(5)}}
    mask = {"b": np.array([True, False, True]), "w": {"k": True, "v": rng.rand(5) > 0.5}}
    return a, b, mask


def _torch(tree):
    return utils.tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_count_parameters_and_to_vec_match_jax():
    a, _, _ = _trees()
    assert utils.count_parameters(_torch(a)) == jutils.count_parameters(_jax(a)) == 16
    for alpha in (1.0, -2.5):
        got = utils.to_vec(_torch(a), alpha=alpha).numpy()
        want = np.asarray(jutils.to_vec(_jax(a), alpha=alpha))
        assert got.shape == want.shape == (16,) and np.array_equal(got, want)


def test_tree_sub_and_where_mask_match_jax():
    a, b, mask = _trees(1)
    got = utils.tree_sub(_torch(a), _torch(b))
    want = jutils.tree_sub(_jax(a), _jax(b))
    for g, w in zip(utils.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    got = utils.tree_where_mask(utils.tree_map(lambda m: torch.as_tensor(np.asarray(m)), mask),
                                _torch(a), _torch(b))
    want = jutils.tree_where_mask(_jax(mask), _jax(a), _jax(b))
    for g, w in zip(utils.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    plain = utils.tree_where_mask({"b": False, "w": {"k": True, "v": True}}, _torch(a), _torch(b))
    assert torch.equal(plain["b"], _torch(b)["b"]) and torch.equal(plain["w"]["k"],
                                                                   _torch(a)["w"]["k"])
