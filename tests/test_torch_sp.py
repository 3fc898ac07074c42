"""Sequence parallelism of the port (``make_pipelined_transformer(...,
seq_axis="sp")`` under ``strategy="sp"`` or ``"dp"``) on the CPU over
gloo, in float64.

At tests/test_pp.py's CFG widths (sequence 8), on 2 ranks (``dp:1,sp:2``)
and 4 (``dp:2,sp:2``): the forward logits and every leaf's gradient (the
stacked blocks and the head's LayerNorm summed over the ``sp`` group once
through *f*, the embedding whole through the split's backward, the pooler
and output not summed), the bilevel program of tests/test_pp.py (darts
under ``"sp"`` and ``"dp"``, CG with ``hvp_mode`` "jvp" and "vjp"), each
within 1e-10 of the JAX package's sequential run and 1e-12 of the port's
one-process run; a forward gathers the keys and the values once a block.
On 2 ranks also tutorial 7's sp mode against ``--mesh none``, compiled
blocks against driver mode and a run cut and auto-resumed. In process: the
split's and gather's rules without ranks.

``tests/torch_pp_impl.py`` runs the JAX references and the groups of ranks
side by side, each with a timeout.
"""

import os
import sys

import pytest
import torch

from betty_tpu_torch import parallel
from betty_tpu_torch.parallel.mesh import Mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_pp_impl as ppi  # noqa: E402

GROUPS = ("sp2", "dp2sp2")
PROGRAMS = ("sp:darts", "dp:darts", "sp:cg_jvp", "sp:cg_vjp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ppi.launch(str(tmp_path_factory.mktemp("sp")), GROUPS)


@pytest.mark.parametrize("group", GROUPS)
def test_sp_forward_and_gradients_match_jax(runs, group):
    ref, got = runs["ref_darts"], runs[group]["forward"]
    assert ppi.err(got["logits"], ref["logits"]) <= 1e-10
    assert set(got["grads"]) == set(ref["grads"])
    errs = {k: ppi.err(got["grads"][k], v) for k, v in ref["grads"].items()}
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("group", GROUPS)
def test_sp_programs_match_jax_sequential_and_one_process(runs, group, program):
    case = runs[group][program]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{program.split(':')[1]}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4  # the parameters moved


@pytest.mark.parametrize("group", GROUPS)
def test_sp_forward_gathers_keys_and_values_once_a_block(runs, group):
    info = runs[group]["forward"]["info"]
    assert info["calls"] == {"seq_gather": 2 * 4}  # k and v, 4 blocks
    assert info["held"]["blocks.attn.query.kernel"] == [4, 16, 2, 8]  # replicated


def test_sp_tutorial_mode_matches_one_process(runs):
    case = runs["sp2"]["tutorial"]
    assert case["ok"], case["info"]


def test_sp_compiled_blocks_equal_driver(runs):
    case = runs["sp2"]["compiled"]
    assert case["ok"], case["info"]


def test_sp_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["sp2"]["resume"]
    assert case["ok"], case["info"]
    assert case["info"]["saved_query_kernel"] == case["info"]["held"] == [4, 16, 2, 8]


def test_sp_split_and_layout_rules():
    mesh = Mesh((("dp", 1), ("sp", 2)), rank=0, world=2)
    with pytest.raises(ValueError, match="sequence of 7 positions"):
        parallel.seq_split(torch.zeros(2, 7, 4), mesh)
    state = {"params": {"blocks.w": torch.zeros(4, 8)}}
    assert parallel.state_shard_dims(state, mesh, "sp") == {}
    with pytest.raises(ValueError, match="'sp'"):
        parallel.state_shard_dims(state, Mesh((("dp", 2),), rank=0, world=2), "sp")
