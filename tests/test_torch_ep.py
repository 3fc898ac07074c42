"""Expert parallelism of the port (``EngineConfig(strategy="ep")``, and
``"tp"`` with ``Config.shard_rules`` naming ``ep`` as
``tests/test_ep.py:131`` does) on the CPU over gloo, in float64.

``tests/test_ep.py``'s bilevel MoE program (``examples/moe_reweighting.py
--dense`` at DIM 16 / HID 32 / E 4 / T 64, 4 iterations) from the JAX
package's initial weights, on 2 ranks (``dp:1,ep:2``) and 4 (``dp:2,ep:2``),
through both routes: within 1e-10 of the JAX package's unsharded run and
1e-12 of the port's one-process run; each rank holds E/2 experts of the
expert leaves and the router and head whole; ep on a program without an
MoE raises, and so does a data-parallel strategy on a mesh with an ``ep``
axis.

``tests/torch_tp_impl.py`` runs the JAX reference and the two groups of
ranks side by side, each with a timeout.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_tp import _tree_err, launch  # noqa: E402

GROUPS = {"ep2": 2, "dp2ep2": 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ep")
    return launch(work, [("ref_moe", "ref_moe", [])], GROUPS)


@pytest.mark.parametrize("route", ["ep", "tp"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_ep_moe_program_matches_jax_unsharded_and_one_process(runs, group, route):
    case = runs[group][f"moe:{route}"]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    err, worst = _tree_err(case["params"], runs["ref_moe"])
    assert err <= 1e-10, worst


@pytest.mark.parametrize("group", list(GROUPS))
def test_ep_ranks_hold_their_experts(runs, group):
    for route in ("ep", "tp"):
        held = runs[group][f"moe:{route}"]["info"]["held"]
        assert held["moe/w1"] == [2, 16, 32] and held["moe/w2"] == [2, 32, 16]
        assert held["moe/b1"] == [2, 32] and held["moe/b2"] == [2, 16]
        assert held["moe/router"] == [16, 4] and held["out"] == [16, 2]


def test_ep_without_an_moe_and_dp_on_an_ep_mesh_raise(runs):
    case = runs["ep2"]["moe:raises"]
    assert case["ok"], case["info"]
