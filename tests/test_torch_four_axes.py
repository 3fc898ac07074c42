"""Four model axes: tests/test_ep.py's MoE program on ``dp:1,ep:2,mdl:2,
pp:2,sp:2`` (``m4``, sixteen gloo ranks), in float64, under
``strategy="tp"`` with ``MOE_COMPOSED_SHARD_RULES``: the experts over
``ep``, each expert's hidden columns over ``mdl``, and the ``pp`` and
``sp`` ranks repeating the layer; darts, 2 steps. Held within 1e-10 of the
JAX package's sequential (unsharded) run of the same 2 steps
(``torch_three_axes_impl.run_ref_moe2``; a repeating axis changes no
value) and within 1e-12 of the port's one-process run; the four ranks of
each ``(ep, mdl)`` coordinate hold bit-equal states.
``tests/torch_three_axes_impl.py`` runs the ranks beside the JAX
references: one launch for the file.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_pp_impl as ppi  # noqa: E402
import torch_three_axes_impl as ti  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ti.launch(str(tmp_path_factory.mktemp("four_axes")), ["m4"])


def test_m4_moe_matches_jax_sequential_and_one_process(runs):
    case = runs["m4"]["moe"]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs["ref_moe2"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4


def test_m4_ranks_hold_their_cut_and_the_repeating_ranks_agree(runs):
    info = runs["m4"]["moe"]["info"]
    assert info["held"]["moe/w1"] == [2, 16, 16] and info["held"]["moe/router"] == [16, 4]
    assert info["gathers"] == {}
    assert info["replicas_equal"] and info["distinct_states"] == 4
