"""Pipeline parallelism of the port (``strategy="pp"``,
``parallel/pipeline.py``, ``models.make_pipelined_transformer``) on the CPU
over gloo, in float64.

At tests/test_pp.py's CFG widths, on 2 ranks (``dp:1,pp:2``, M 2) and 4
(``dp:2,pp:2``, M 4): the forward logits and every leaf's gradient (the
embedding and the head included: no S-fold gradient), tests/test_pp.py's
``_run_engine`` bilevel program (darts, unroll 2, 3 iterations; under
``strategy="pp"`` and under ``"tp"`` with ``shard_rules=((r"^blocks",
("pp",)),)``) and the same under CG with ``hvp_mode`` "jvp" and "vjp", each
within 1e-10 of the JAX package's sequential run and 1e-12 of the port's
one-process run. On 2 ranks also: a forward makes M + S - 1 ring shifts;
each rank holds ``depth / S`` of every stacked leaf and of its Adam moments;
compiled blocks equal driver mode; a run cut and auto-resumed equals the
uninterrupted one (its checkpoint holding whole tensors); tutorial 7's pp
mode equals ``--mesh none``; the JAX package's loud errors. In process: the
layouts and the errors that need no ranks.

``tests/torch_pp_impl.py`` runs the JAX references (one process a solver)
and the two groups of ranks side by side, each with a timeout.
"""

import os
import sys

import pytest
import torch

from betty_tpu_torch import EngineConfig, parallel
from betty_tpu_torch.models import make_pipelined_transformer
from betty_tpu_torch.parallel.mesh import Mesh
from betty_tpu_torch.parallel.pipeline import gpipe, sequential

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_pp_impl as ppi  # noqa: E402

GROUPS = ("pp2", "dp2pp2")
PROGRAMS = ("pp:darts", "tp:darts", "pp:cg_jvp", "pp:cg_vjp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ppi.launch(str(tmp_path_factory.mktemp("pp")), GROUPS)


@pytest.mark.parametrize("group", GROUPS)
def test_pp_forward_and_gradients_match_jax(runs, group):
    ref, got = runs["ref_darts"], runs[group]["forward"]
    assert ppi.err(got["logits"], ref["logits"]) <= 1e-10
    assert set(got["grads"]) == set(ref["grads"])
    errs = {k: ppi.err(got["grads"][k], v) for k, v in ref["grads"].items()}
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    # the embedding's and the head's gradients (held above, not S-fold) are not 0
    assert max(ppi.err(got["grads"][k], 0.0) for k in ("embed.tok", "head.pool_w")) > 1e-6


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("group", GROUPS)
def test_pp_programs_match_jax_sequential_and_one_process(runs, group, program):
    case = runs[group][program]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{program.split(':')[1]}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4  # the parameters moved


@pytest.mark.parametrize("group,steps", [("pp2", 2 + 2 - 1), ("dp2pp2", 4 + 2 - 1)])
def test_pp_forward_makes_m_plus_s_minus_1_ring_shifts(runs, group, steps):
    assert runs[group]["forward"]["info"]["calls"] == {"ring_shift": steps}


def test_pp_ranks_hold_a_stage_and_its_moments(runs):
    held = runs["pp2"]["forward"]["info"]["held"]
    assert held["blocks.attn.query.kernel"] == [2, 16, 2, 8]  # 2 of the 4 blocks
    assert held["blocks.fc1.weight"] == [2, 64, 16] and held["embed.tok"] == [64, 16]
    resume = runs["pp2"]["resume"]["info"]
    assert resume["held"] == resume["moment_held"] == [2, 16, 2, 8]  # Adam's moments alike
    tutorial = runs["pp2"]["tutorial"]["info"]
    assert tutorial["held"]["blocks.attn.query.kernel"] == [2, 64, 4, 16]
    assert tutorial["moments"]["blocks.attn.query.kernel"] == [2, 64, 4, 16]
    assert tutorial["held"]["head.pool_w"] == tutorial["moments"]["head.pool_w"] == [64, 64]


def test_pp_compiled_blocks_equal_driver(runs):
    case = runs["pp2"]["compiled"]
    assert case["ok"], case["info"]


def test_pp_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["pp2"]["resume"]
    assert case["ok"], case["info"]
    assert case["info"]["saved_query_kernel"] == [4, 16, 2, 8]  # the checkpoint holds whole tensors


def test_pp_tutorial_mode_matches_one_process(runs):
    case = runs["pp2"]["tutorial"]
    assert case["ok"], case["info"]


def test_pp_loud_errors_name_their_subject(runs):
    """tests/test_composed.py:113-130 and 192-228 on the port: the same
    kinds and subjects."""
    info = runs["pp2"]["errors"]["info"]
    assert info["pp_without_axis"].startswith("ValueError") and "'pp'" in info["pp_without_axis"]
    assert info["pp_without_blocks"].startswith("ValueError") and "blocks" in \
        info["pp_without_blocks"]
    assert info["sp_without_axis"].startswith("ValueError") and "'sp'" in info["sp_without_axis"]
    assert info["ep_without_moe"].startswith("ValueError") and "expert" in info["ep_without_moe"]
    assert info["odd_depth"].startswith("ValueError") and "divisible" in info["odd_depth"]


# ---------------------------------------------------------------------------
# in process: layouts and errors
# ---------------------------------------------------------------------------


def _stacked_params():
    return make_pipelined_transformer(None, vocab_size=64, max_len=8, dim=16, depth=4,
                                      heads=2).variables["params"]


def test_pp_rules_shard_the_stacked_blocks_only():
    params = _stacked_params()
    state = {"params": params, "opt_state": {"count": 0, "mu": params, "nu": params}}
    mesh = Mesh((("dp", 2), ("pp", 2)), rank=0, world=4)
    dims = parallel.state_shard_dims(state, mesh, "pp")
    for k in params:
        assert dims["params"][k] == (0 if k.startswith("blocks.") else None), k
        assert dims["opt_state"]["mu"][k] == dims["params"][k]
    assert dims["opt_state"]["count"] is None
    # tp with the tutorial's rule gives the same layout; the leaves no rule
    # names stay replicated on a pp mesh (the JAX package's tp_shardings
    # would shard the large ones over dp: ROADMAP.md §C, kept on purpose)
    tp = parallel.state_shard_dims(state, mesh, "tp", rules=((r"^blocks", ("pp",)),))
    assert tp["params"] == dims["params"] and tp["opt_state"]["nu"] == dims["params"]
    assert tp["params"]["embed.tok"] is None and tp["params"]["head.pool_w"] is None
    # a non-pipelined problem stays replicated (tests/test_composed.py:285)
    big = {"params": {"Dense_0": {"kernel": torch.ones(128, 64)}}}
    assert parallel.state_shard_dims(big, mesh, "pp") == {}
    assert not parallel.strategy_matches("pp", big)
    assert parallel.strategy_matches("pp", state)
    assert not parallel.strategy_matches("pp", {"params": {"blocks.0.ln1.weight": torch.ones(4)}})


def test_composed_mesh_raises_naming_the_roadmap():
    """The ``dp x mdl x pp`` composition is computed (tests/test_torch_composed.py);
    three model axes still raise, naming ROADMAP.md §A.8."""
    composed = (("dp", 2), ("mdl", 2), ("pp", 2))
    assert EngineConfig(strategy="tp", mesh_shape=composed).mesh_shape == composed
    three = composed + (("sp", 2),)
    with pytest.raises(NotImplementedError, match="§A.8.*compositions left uncomputed"):
        EngineConfig(strategy="tp", mesh_shape=three)
    with pytest.raises(NotImplementedError, match="§A.8"):
        parallel.make_mesh(three)


def test_gpipe_checks_depth_and_batch():
    """JAX's error texts (``betty_tpu/parallel/pipeline.py:68-71``)."""
    mesh = Mesh((("dp", 1), ("pp", 2)), rank=0, world=2)
    block = lambda p, c: c  # noqa: E731
    x = (torch.zeros(6, 3),)
    with pytest.raises(ValueError, match="depth 3 not divisible by 2 pipeline stages"):
        gpipe(block, {"w": torch.zeros(3, 2)}, x, mesh)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 microbatches"):
        gpipe(block, {"w": torch.zeros(4, 2)}, x, mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="model axis is 'pp'"):
        gpipe(block, {"w": torch.zeros(4, 2)}, x, None)
    # sequential applies the stacked blocks in order
    out, = sequential(lambda p, c: (c[0] * p["w"],), {"w": torch.tensor([2.0, 3.0])},
                      (torch.ones(1),))
    assert float(out) == 6.0
