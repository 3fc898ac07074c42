"""Megatron-SP and the Switch MoE on three model axes, on eight gloo ranks
each, in float64:

* ``m3sp`` (``dp:1,mdl:2,sp:2,ep:2``): the pipelined transformer built
  with ``seq_axis="sp"`` under ``strategy="tp"`` with
  ``models.SP_COMPOSED_SHARD_RULES`` computes Megatron-SP over ``mdl x sp``
  (its heads and MLP columns over ``mdl``, its positions over ``sp``), and
  the ``ep`` ranks repeat it; darts.
* ``m3moe`` (``dp:1,ep:2,mdl:2,pp:2``): tests/test_ep.py's MoE program
  under ``strategy="tp"`` with ``MOE_COMPOSED_SHARD_RULES`` computes its
  experts over ``ep`` and each expert's hidden columns over ``mdl``, and
  the ``pp`` ranks repeat it; darts and ITD. The layer's tokens enter
  through *f* over the ``ep+mdl`` pair's group: over the whole model group
  the ``pp`` copies of each cotangent would be summed too.

Each within 1e-10 of the JAX package's sequential (unsharded) run of the
same program (tests/torch_pp_impl.py's ``darts``, tests/torch_tp_impl.py's
``ref_moe``, tests/torch_itd_parallel_impl.py's ``moe``; a repeating axis
changes no value, so JAX's run on the mesh equals them) and within 1e-12
of the port's one-process run; the repeating ranks hold bit-equal states.
``tests/torch_three_axes_impl.py`` runs both groups beside the three JAX
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
    return ti.launch(str(tmp_path_factory.mktemp("three_axes_moe")), ["m3sp", "m3moe"])


def test_m3sp_megatron_sp_matches_jax_sequential_and_one_process(runs):
    case = runs["m3sp"]["tp:darts"]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs["ref_darts"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4
    info = case["info"]
    # every block, half the heads; only sp's keys and values are gathered
    assert info["held"] == [4, 16, 1, 8] and set(info["gathers"]) == {"sp"}
    assert info["ep_replicas_equal"] and info["distinct_states"] == 2


def test_m3moe_matches_jax_sequential_and_one_process(runs):
    case = runs["m3moe"]["moe"]
    assert case["ok"], case["info"]
    assert ppi.tree_err(case["params"], runs["ref_moe"]) <= 1e-10
    info = case["info"]
    # E/ep experts, h/mdl of each one's hidden columns; no parameter gathered
    assert info["held"]["moe/w1"] == [2, 16, 16] and info["held"]["moe/b2"] == [2, 16]
    assert info["gathers"] == {}
    assert info["replicas_equal"] and info["distinct_states"] == 4


def test_m3moe_itd_matches_jax_sequential_and_one_process(runs):
    case = runs["m3moe"]["itd"]
    assert case["ok"], case["info"]
    ref = runs["ref_itd_moe"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4
