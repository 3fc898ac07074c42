"""The solvers' vector kernels (B6-B8): the port's plain versions against
betty_tpu's Pallas kernels (interpret mode on the CPU, as tests/test_ops.py
runs them), the ravel/unravel round trip, and the CPU wrappers taking the
plain versions.

Inputs are numpy-seeded float32 vectors of 3 * TILE elements. Elementwise
outputs agree within 1e-6 (both sides round the same float32 products;
fused multiply-add on one side may differ by an ulp), dots within 1e-5
relative to sum |a_i b_i|, since the two sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.ops import cg_fused_step as j_cg_step
from betty_tpu.ops import fused_dot2 as j_dot2
from betty_tpu.ops import neumann_fused_step as j_neumann_step
from betty_tpu.ops import tree_ravel as j_tree_ravel
from betty_tpu.ops.vector import TILE as J_TILE
from betty_tpu_torch.ops import vector as tv

N = 3 * tv.TILE


def _vecs(count, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(N).astype(np.float32) for _ in range(count)]


def _close_dot(got, want, a, b):
    scale = float(np.sum(np.abs(a.astype(np.float64) * b.astype(np.float64))))
    assert abs(float(got) - float(want)) <= 1e-5 * scale, (float(got), float(want), scale)


def test_tile_matches_betty_tpu():
    assert tv.TILE == J_TILE


def test_dot2_plain_matches_pallas():
    a, b, c, d = _vecs(4, 0)
    jab, jcd = j_dot2(*(jnp.asarray(x) for x in (a, b, c, d)))
    tab, tcd = tv.fused_dot2_plain(*(torch.from_numpy(x) for x in (a, b, c, d)))
    _close_dot(tab, jab, a, b)
    _close_dot(tcd, jcd, c, d)


def test_cg_step_plain_matches_pallas():
    x, p, r, hvp = _vecs(4, 1)
    ak = np.float32(0.37)
    jx, jr, jrr = j_cg_step(ak, *(jnp.asarray(v) for v in (x, p, r, hvp)))
    tx, tr, trr = tv.cg_fused_step_plain(torch.tensor(ak), *(torch.from_numpy(v)
                                                            for v in (x, p, r, hvp)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    _close_dot(trr, jrr, np.asarray(jr), np.asarray(jr))


def test_neumann_step_plain_matches_pallas():
    v, hv, p = _vecs(3, 2)
    jv, jp = j_neumann_step(0.5, *(jnp.asarray(x) for x in (v, hv, p)))
    tv2, tp2 = tv.neumann_fused_step_plain(0.5, *(torch.from_numpy(x) for x in (v, hv, p)))
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_tree_ravel_roundtrip(dtype):
    rng = np.random.RandomState(3)
    tree = {"a": torch.tensor(rng.randn(2, 3)).to(dtype),
            "b": {"c": torch.tensor(rng.randn(5)).to(dtype), "d": torch.tensor(1.5).to(dtype)}}
    flat, n = tv.tree_ravel(tree)
    assert n == 12 and flat.numel() == tv.TILE
    assert flat.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
    assert torch.equal(flat[n:], torch.zeros(tv.TILE - n, dtype=flat.dtype))
    # the same order and padding as betty_tpu's ravel
    jflat, jn = j_tree_ravel({"a": jnp.asarray(tree["a"].float().numpy()),
                              "b": {"c": jnp.asarray(tree["b"]["c"].float().numpy()),
                                    "d": jnp.asarray(tree["b"]["d"].float().numpy())}})
    assert jn == n and np.array_equal(np.asarray(jflat), flat.float().numpy())
    back = tv.tree_unravel(tree, flat)
    for got, want in ((back["a"], tree["a"]), (back["b"]["c"], tree["b"]["c"]),
                      (back["b"]["d"], tree["b"]["d"])):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_cpu_wrappers_take_the_plain_versions():
    tv.reset_launch_counts()
    a, b, c, d = (torch.from_numpy(x) for x in _vecs(4, 4))
    ak = torch.tensor(0.25)
    for got, want in ((tv.fused_dot2(a, b, c, d), tv.fused_dot2_plain(a, b, c, d)),
                      (tv.cg_fused_step(ak, a, b, c, d), tv.cg_fused_step_plain(ak, a, b, c, d)),
                      (tv.neumann_fused_step(0.5, a, b, c),
                       tv.neumann_fused_step_plain(0.5, a, b, c))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (tv.fused_dot2.launches, tv.cg_fused_step.launches,
            tv.neumann_fused_step.launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="equal length"):
        tv.fused_dot2(a, b, c, d[:-1])
