"""Sequence parallelism and the Switch MoE beside a second model axis, on the
CPU over gloo, in float64:

* Megatron-SP (``make_pipelined_transformer(seq_axis="sp")`` on ``(dp, mdl,
  sp)`` under ``strategy="tp"`` with ``models.SP_COMPOSED_SHARD_RULES``:
  each rank's heads and MLP columns over ``mdl``, its positions over
  ``sp``) on ``mdl2sp2`` (``dp:1,mdl:2,sp:2``, 4 ranks) and ``dp2mdl2sp2``
  (``dp:2,mdl:2,sp:2``, 8 ranks): the forward and every gradient, darts and
  CG (jvp, vjp, fused), ``strategy="sp"`` on the same mesh, each within
  1e-10 of the JAX package's unsharded run and 1e-12 of the port's one
  process; the shards and Adam moments, compiled blocks against driver
  mode and a run cut and auto-resumed, bit for bit.
* Expert plus tensor parallelism (``moe_ffn`` on ``(dp, ep, mdl)`` with
  ``models.MOE_COMPOSED_SHARD_RULES``: E/ep experts, h/mdl of each one's
  hidden columns) on ``ep2mdl2`` (4 ranks): tests/test_ep.py's program
  under ``strategy="tp"`` and ``"ep"`` against JAX's unsharded run, the
  shards, compiled against driver, the layer's kept and dropped tokens.
* An axis a module does not split repeats its work: the encoder on
  ``pp:2,sp:2`` and ``ep:2,sp:2`` (``pp2sp2``), the MoE on ``ep:2,pp:2`` and
  ``ep:2,sp:2`` (``ep2pp2``), against JAX.

``tests/torch_composed_sp_moe_impl.py`` runs the ranks beside the JAX
references (``torch_pp_impl.py``'s three, ``torch_tp_impl.py``'s
``ref_moe``): one launch for the file.
"""

import os
import sys

import pytest
import torch

from betty_tpu_torch import parallel
from betty_tpu_torch.models import (MOE_COMPOSED_SHARD_RULES, SP_COMPOSED_SHARD_RULES,
                                    init_moe_params, make_pipelined_transformer,
                                    pipelined_shard_rules)
from betty_tpu_torch.parallel.mesh import Cut, Mesh, moe_local_dim

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_composed_sp_moe_impl as ci  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402
from test_torch_tp import _tree_err  # noqa: E402

SP_GROUPS = tuple(ci.GROUP_PROGRAMS)
SP_CASES = [(g, p) for g in SP_GROUPS for p in ci.GROUP_PROGRAMS[g]]
EP_MDL = ci.GROUPS["ep2mdl2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ci.launch(str(tmp_path_factory.mktemp("sp_moe")))


# ---------------------------------------------------------------------------
# mdl x sp: Megatron-SP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", SP_GROUPS)
def test_sp_mdl_forward_and_gradients_match_jax(runs, group):
    ref, got = runs["ref_darts"], runs[group]["forward"]
    assert ppi.err(got["logits"], ref["logits"]) <= 1e-10
    assert set(got["grads"]) == set(ref["grads"])
    errs = {k: ppi.err(got["grads"][k], v) for k, v in ref["grads"].items()}
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert min(ppi.err(got["grads"][k], 0.0) for k in
               ("blocks.attn.query.kernel", "blocks.fc2.weight", "embed.tok")) > 1e-6
    info = got["info"]
    # sharded_norm counts every element once; the keys and values of the 4
    # blocks gathered over sp, two a block
    assert abs(info["norm"] - info["whole_norm"]) <= 1e-12 * info["whole_norm"]
    assert info["calls"] == {"seq_gather": 2 * 4}


@pytest.mark.parametrize("group,program", SP_CASES)
def test_sp_mdl_programs_match_jax_and_one_process(runs, group, program):
    case = runs[group][program]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{ci.PROGRAMS[program][1]}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4  # the parameters moved
    # nothing gathered on use over a model axis: only the keys and values
    # over sp (and under sp the batch's metrics over nothing else)
    gathers = case["info"]["gathers"]
    assert gathers.get("sp", 0) > 0 and not {"mdl", "model"} & set(gathers), gathers


def test_sp_mdl_ranks_hold_their_heads_columns_and_moments(runs):
    held = runs["mdl2sp2"]["forward"]["info"]["held"]
    # (depth, d, H, Dh) = (4, 16, 2, 8): H/2 heads, hidden/2 MLP columns
    assert held["blocks.attn.query.kernel"] == [4, 16, 1, 8]
    assert held["blocks.attn.out.kernel"] == [4, 1, 8, 16]
    assert held["blocks.fc1.weight"] == [4, 32, 16] and held["blocks.fc2.weight"] == [4, 16, 32]
    # the biases and LayerNorms whole (cut where they are used), the rest whole
    assert held["blocks.attn.query.bias"] == [4, 2, 8] and held["blocks.fc1.bias"] == [4, 64]
    assert held["embed.tok"] == [64, 16] and held["head.pool_w"] == [16, 16]
    resume = runs["mdl2sp2"]["resume"]["info"]
    assert resume["held"]["blocks.attn.query.kernel"] == [4, 16, 1, 8]
    assert all(resume["moments"][k] == [v] * 2 for k, v in resume["held"].items())


def test_sp_mdl_compiled_blocks_equal_driver(runs):
    case = runs["mdl2sp2"]["compiled"]
    assert case["ok"], case["info"]


def test_sp_mdl_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["mdl2sp2"]["resume"]
    assert case["ok"], case["info"]
    assert case["info"]["saved"] == {"blocks.attn.query.kernel": [4, 16, 2, 8],
                                     "blocks.fc2.weight": [4, 16, 64]}


# ---------------------------------------------------------------------------
# ep x mdl: the MoE's experts over ep, their hidden columns over mdl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["tp", "ep"])
def test_moe_ep_mdl_program_matches_jax_unsharded_and_one_process(runs, strategy):
    case = runs["ep2mdl2"][f"moe:{strategy}:{EP_MDL}"]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    err, worst = _tree_err(case["params"], runs["ref_moe"])
    assert err <= 1e-10, worst
    gathers = case["info"]["gathers"]
    assert not {"ep", "mdl", "model"} & set(gathers), gathers


def test_moe_ep_mdl_ranks_hold_experts_and_columns(runs):
    held = runs["ep2mdl2"][f"moe:tp:{EP_MDL}"]["info"]["held"]
    # E 4, d 16, h 32: [E/2, d, h/2]
    assert held["moe/w1"] == [2, 16, 16] and held["moe/w2"] == [2, 16, 16]
    assert held["moe/b1"] == [2, 16] and held["moe/b2"] == [2, 16]
    assert held["moe/router"] == [16, 4] and held["out"] == [16, 2]
    # strategy "ep" keeps JAX's _ep_rules placement: experts over ep alone
    held = runs["ep2mdl2"][f"moe:ep:{EP_MDL}"]["info"]["held"]
    assert held["moe/w1"] == [2, 16, 32] and held["moe/b1"] == [2, 32]


def test_moe_ep_mdl_layer_keeps_and_drops_the_tokens_of_one_process(runs):
    case = runs["ep2mdl2"]["moe:layer"]
    assert case["ok"], case["info"]
    assert case["info"]["2"]["dropped"] > 0  # capacity 2 drops tokens, alike on every rank


def test_moe_ep_mdl_compiled_blocks_equal_driver(runs):
    case = runs["ep2mdl2"]["moe:compiled"]
    assert case["ok"], case["info"]


# ---------------------------------------------------------------------------
# an axis a module does not split repeats its work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,strategy,query", [
    ("dp:1,pp:2,sp:2", "pp", [2, 16, 2, 8]), ("dp:1,ep:2,sp:2", "sp", [4, 16, 2, 8])])
def test_encoder_beside_an_axis_it_does_not_split_matches_jax(runs, mesh, strategy, query):
    case = runs["pp2sp2"][f"encoder:{mesh}"]
    assert case["ok"], case["info"]
    assert case["info"]["strategy"] == strategy and case["info"]["held"] == query
    assert ppi.tree_err(case["params"], runs["ref_darts"]["final"]) <= 1e-10


@pytest.mark.parametrize("mesh", ["dp:1,ep:2,pp:2", "dp:1,ep:2,sp:2"])
def test_moe_beside_pp_or_sp_matches_jax(runs, mesh):
    case = runs["ep2pp2"][f"moe:ep:{mesh}"]
    assert case["ok"], case["info"]
    err, worst = _tree_err(case["params"], runs["ref_moe"])
    assert err <= 1e-10, worst
    assert case["info"]["held"]["moe/w1"] == [2, 16, 32]


# ---------------------------------------------------------------------------
# in process: the layouts
# ---------------------------------------------------------------------------


def test_sp_composed_rules_cut_heads_and_columns_and_the_moments_alike():
    params = make_pipelined_transformer(None, vocab_size=64, max_len=8, dim=16, depth=4,
                                        heads=2).variables["params"]
    state = {"params": params, "opt_state": {"count": 0, "mu": params, "nu": params}}
    for axes in ((("dp", 2), ("mdl", 2), ("sp", 2)), (("dp", 2), ("sp", 2), ("mdl", 2))):
        mesh = Mesh(axes, rank=5, world=8)
        assert pipelined_shard_rules(mesh) is SP_COMPOSED_SHARD_RULES
        dims = parallel.state_shard_dims(state, mesh, "tp", rules=SP_COMPOSED_SHARD_RULES)
        p = dims["params"]
        assert p["blocks.attn.query.kernel"] == Cut(((2, "mdl"),))
        assert p["blocks.attn.out.kernel"] == Cut(((1, "mdl"),))
        assert p["blocks.fc1.weight"] == Cut(((1, "mdl"),))
        assert p["blocks.fc2.weight"] == Cut(((2, "mdl"),))
        assert p["blocks.attn.query.bias"] is None and p["embed.tok"] is None
        assert dims["opt_state"]["mu"] == p and dims["opt_state"]["count"] is None
        shard = parallel.mesh.shard_tree(params, p, mesh, "model")
        i = mesh.axis_index("mdl")
        assert torch.equal(shard["blocks.fc2.weight"],
                           params["blocks.fc2.weight"][:, :, 32 * i:32 * (i + 1)])
    # strategy "sp" keeps every parameter whole
    assert parallel.state_shard_dims(state, mesh, "sp") == {}


def test_moe_composed_rules_cut_experts_and_columns_and_the_moments_alike():
    params = {"moe": init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4),
              "out": torch.zeros(16, 2)}
    state = {"params": params, "opt_state": {"mu": params, "nu": params}}
    mesh = Mesh((("dp", 1), ("ep", 2), ("mdl", 2)), rank=2, world=4)  # ep 1, mdl 0
    dims = parallel.state_shard_dims(state, mesh, "tp", rules=MOE_COMPOSED_SHARD_RULES)
    p = dims["params"]["moe"]
    assert p["w1"] == Cut(((0, "ep"), (2, "mdl"))) and p["w2"] == Cut(((0, "ep"), (1, "mdl")))
    assert p["b1"] == Cut(((0, "ep"), (1, "mdl"))) and p["b2"] == Cut(((0, "ep"),))
    assert p["router"] is None and dims["params"]["out"] is None
    assert dims["opt_state"]["nu"] == dims["params"]
    shard = parallel.mesh.shard_tree(params, dims["params"], mesh, "model")
    assert torch.equal(shard["moe"]["w1"], params["moe"]["w1"][2:4, :, 0:16])
    # the module computes on exactly these cuts: the problem gathers nothing
    for leaf, cut in p.items():
        assert moe_local_dim(f"moe/{leaf}", mesh) == (cut if leaf != "router" else None)
    # strategy "ep": JAX's _ep_rules placement, the experts over ep alone
    ep = parallel.state_shard_dims(state, mesh, "ep")["params"]["moe"]
    assert ep["w1"] == ep["b2"] == Cut(((0, "ep"),)) and ep["router"] is None
    # beside pp the experts still go over ep; on one model axis the expert dim
    assert moe_local_dim("moe/w1", Mesh((("dp", 1), ("ep", 2), ("pp", 2)), rank=0, world=4)) \
        == Cut(((0, "ep"),))
    assert moe_local_dim("moe/w1", Mesh((("dp", 1), ("ep", 2)), rank=0, world=2)) == 0
