"""The port's DARTS search space (``betty_tpu_torch/models/darts.py``) against
flax's (``betty_tpu/models/darts.py``) on the same numpy-seeded inputs, with
the port's weights carried to flax (``torch_darts_common.to_flax``, the
inverse of ``convert.from_flax_darts``), in float32 (1e-5) and float64
(1e-10), errors relative to max(1, max|flax|) of each output, statistic
and input gradient, and of the whole parameter gradient (its largest
entry: a float32 gradient deep inside a cell carries the rounding of the
BatchNorm backwards above it):

* every op at stride 1 and 2 on even and odd sizes (both pools, SepConv
  3/5, DilConv 3/5, ReLUConvBN, FactorizedReduce): output, new running
  statistics, gradients to the input and the params;
* the genotype: ``derive_genotype`` on random alphas, the JSON in both
  directions, DARTS_V2; the conversion's names against flax's own tree;
* drop-path's mask shape, scaling and rate (its bits come from another
  generator than JAX's threefry).

MixedOp and the cells are held in ``test_torch_darts_cells.py``, the
networks in ``test_torch_darts_networks.py`` and
``test_torch_darts_eval_network.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.models import darts as J
from betty_tpu_torch import convert
from betty_tpu_torch.models import darts as T
from torch_darts_common import assert_within, compare, module_state, one_thread, to_flax

DTYPES = [torch.float32, torch.float64]
IDS = ["f32", "f64"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _images(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


OPS = {
    "sep_conv_3x3": lambda c, s: (J.SepConv(c, 3, s), T.SepConv(c, c, 3, s)),
    "sep_conv_5x5": lambda c, s: (J.SepConv(c, 5, s), T.SepConv(c, c, 5, s)),
    "dil_conv_3x3": lambda c, s: (J.DilConv(c, 3, s), T.DilConv(c, c, 3, s)),
    "dil_conv_5x5": lambda c, s: (J.DilConv(c, 5, s), T.DilConv(c, c, 5, s)),
    "relu_conv_bn": lambda c, s: (J.ReLUConvBN(c, 3, s), T.ReLUConvBN(c, c, 3, s)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_flax(op, stride, size, dtype):
    jm, tm = OPS[op](6, stride)
    assert_within(compare(jm, tm, [_images((3, size, size, 6))], dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("size", [8, 9])
def test_factorized_reduce_matches_flax(size, dtype):
    """The shifted half ``x[:, 1:, 1:]`` is padded at the end on odd sizes."""
    assert_within(compare(J.FactorizedReduce(6), T.FactorizedReduce(6, 6),
                            [_images((3, size, size, 6))], dtype), dtype)


class _JPool:
    """``J._pool`` as an object with flax's ``apply``."""

    def __init__(self, kind, stride):
        self.kind, self.stride = kind, stride

    def apply(self, variables, x, train=True, mutable=()):
        return J._pool(x, self.kind, self.stride), {"batch_stats": {}}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_matches_flax(kind, stride, size, dtype):
    """SAME padding: -inf for max, counted zeros for avg (every window
    divides by 9, the stride-2 (0, 1) padding included)."""
    errs = compare(_JPool(kind, stride), T.Pool(kind, stride), [_images((3, size, size, 5))],
                    dtype)
    assert_within(errs, dtype)
    if kind == "avg":  # the corner of a stride-1 pool sums 4 values over 9
        x = torch.ones(1, 1, size, size, dtype=dtype)
        assert float(T._pool(x, "avg", 1)[0, 0, 0, 0]) == pytest.approx(4 / 9, abs=1e-7)


def _jax_alphas(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*T.num_alphas()).astype(np.float32) for k in ("normal", "reduce")}


def test_derive_genotype_matches_jax_on_random_alphas():
    assert T.PRIMITIVES == J.PRIMITIVES and T.num_alphas() == J.num_alphas() == (14, 8)
    for seed in range(20):
        a = _jax_alphas(seed)
        got = T.derive_genotype({k: torch.from_numpy(v) for k, v in a.items()})
        want = J.derive_genotype({k: jnp.asarray(v) for k, v in a.items()})
        assert got == want, seed
        assert len(got.normal) == len(got.reduce) == 8


def test_genotype_json_crosses_packages(tmp_path):
    assert T.DARTS_V2 == J.DARTS_V2
    g = T.derive_genotype({k: torch.from_numpy(v) for k, v in _jax_alphas(7).items()})
    for text in (T.genotype_to_json(g), J.genotype_to_json(g)):
        assert T.genotype_from_json(text) == J.genotype_from_json(text) == g
    assert T.genotype_to_json(T.DARTS_V2) == J.genotype_to_json(J.DARTS_V2)


def test_conversion_names_match_flax_trees():
    """``to_flax`` (and so ``from_flax_darts``) names every conv, BatchNorm
    and dense of the supernet and the evaluation network as flax's own
    init does (``jax.eval_shape``: the tree without compiling), and the two
    conversions are inverses."""
    x = jnp.zeros((2, 32, 32, 3))
    cases = [(J.DARTSNetwork(channels=2, layers=3), T.DARTSNetwork(channels=2, layers=3),
              (x, J.init_alphas()), {}),
             (J.DARTSEvalNetwork(J.DARTS_V2, channels=2, layers=6),
              T.DARTSEvalNetwork(T.DARTS_V2, channels=2, layers=6), (x, 0.0), {})]
    for jnet, tnet, args, kw in cases:
        shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *args, train=True))
        params, stats = module_state(tnet)
        mine = to_flax(tnet, params, stats)
        want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
        assert {k: tuple(v.shape) for k, v in _flat(mine).items()} == want
        back_p, back_s = convert.from_flax_darts(mine, tnet, dtype=torch.float64)
        assert all(torch.equal(back_p[k], params[k]) for k in params) and set(back_p) == set(params)
        assert all(torch.equal(back_s[k], stats[k]) for k in stats) and set(back_s) == set(stats)


def test_supernet_counts_at_the_search_width():
    """C16 L8: 1,399 parameter leaves (1,394 convolutions in the cells), 929
    BatchNorms of which 928 have no scale or bias."""
    net = T.DARTSNetwork(channels=16, layers=8)
    bns = [m for m in net.modules() if isinstance(m, T.BatchNorm)]
    assert len(list(net.parameters())) == 1399
    assert len(bns) == 929 and sum(m.weight is None for m in bns) == 928
    assert [c.reduction for c in net.cells] == [False, False, True, False, False, True, False,
                                                False]


def test_init_alphas_from_a_generator():
    a = T.init_alphas(torch.Generator().manual_seed(1))
    b = T.init_alphas(torch.Generator().manual_seed(1))
    assert set(a) == {"normal", "reduce"} and a["normal"].shape == (14, 8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert 1e-4 < float(a["normal"].std()) < 1e-2
    assert not torch.equal(a["normal"], a["reduce"])


def test_drop_path_mask_scaling_and_rate():
    """Per-sample masks (N, 1, 1, 1) drawn as uniform < keep, survivors
    scaled by 1/keep, as JAX's ``drop_path``; the kept share is keep within
    5 sigma over 20,000 samples in both packages; a probability of 0 (a
    tensor, as the schedule's) keeps every sample unchanged."""
    x = torch.rand(20000, 2, 3, 3, dtype=torch.float64) + 0.5
    drop = 0.3
    out = T.drop_path(x, torch.tensor(drop, dtype=torch.float32),
                      torch.Generator().manual_seed(0))
    kept = (out != 0).reshape(len(x), -1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # whole samples
    k = kept.all(1)
    assert torch.allclose(out[k], x[k] / (1 - drop), rtol=1e-7, atol=0)
    sigma = (drop * (1 - drop) / len(x)) ** 0.5
    assert abs(float(k.double().mean()) - (1 - drop)) < 5 * sigma
    jout = np.asarray(J.drop_path(jnp.asarray(x.numpy(), jnp.float32), drop,
                                  jax.random.PRNGKey(0)))
    jk = (jout.reshape(len(x), -1) != 0).all(1)
    assert abs(float(jk.mean()) - (1 - drop)) < 5 * sigma
    zero = T.drop_path(x, torch.tensor(0.0), torch.Generator().manual_seed(1))
    assert torch.equal(zero, x)
    a = T.drop_path(x, drop, torch.Generator().manual_seed(3))
    b = T.drop_path(x, drop, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_eval_network_draws_drop_path_from_the_droppath_rng():
    net = T.DARTSEvalNetwork(T.DARTS_V2, channels=2, layers=3, auxiliary=False)
    x = torch.randn(4, 32, 32, 3)
    dp = torch.tensor(0.5)
    a, _ = net(x, dp, train=True, rngs={"dropout": 1, "droppath": 7})
    b, _ = net(x, dp, train=True, rngs={"dropout": 1, "droppath": 7})
    c, _ = net(x, dp, train=True, rngs={"dropout": 1, "droppath": 8})
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="droppath"):
        net(x, dp, train=True)
    ev, aux = net(x, dp, train=False)
    assert aux is None and torch.equal(ev, net(x, dp, train=False)[0])
