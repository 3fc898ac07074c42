"""ITD replays under model parallelism, on the CPU over gloo, in float64.

An ``IterativeProblem`` child under a ``Config(first_order=False)`` parent
is differentiated through its unroll: the parent's update replays the
child's recorded steps as a differentiable function of its context. Under
tp, ep, pp and sp, and on two model axes, the replay computes in the
update's layout: it starts from this rank's shards of the recorded state,
hands them to the loss (gathered or cut on use, as in an eager step),
keeps each micro-step's gradient in the shards' layout (averaged over the
batch ranks only), steps the shards, and returns them.

Each mesh runs the ITD variant of the program its model-parallel test
holds (``tests/torch_itd_parallel_impl.py``): tutorial 7's tp program at
small width on ``dp:1,mdl:2`` and ``dp:2,mdl:2``, the MoE program on
``dp:1,ep:2`` and ``dp:1,ep:2,mdl:2``, tests/torch_pp_impl.py's program
on ``dp:1,pp:2`` (M 2), ``dp:1,sp:2``, ``dp:1,mdl:2,pp:2`` and
``dp:1,mdl:2,sp:2``. Both problems' parameters are held within 1e-10 of
the JAX package's sequential, unsharded ITD run and within 1e-12 of the
port's one-process run; the replay's collective calls a micro-step equal
an eager step's (no gather of the start state), and its optimizer steps
the shards. On ``dp:1,mdl:2`` also gradient accumulation with clipping
and a ``grad_callback``, a MAML program whose unroll starts from
meta-parameters held whole, and a run cut mid-unroll and auto-resumed;
compiled blocks equal driver mode on ``dp:1,mdl:2`` and
``dp:1,mdl:2,pp:2``. One launch for the file: the five JAX references
beside four groups of ranks.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_itd_parallel_impl as ipi  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402

MESHES = tuple(ipi.MESHES)
GROUP_OF = {m: g for g, ms in ipi.GROUP_MESHES.items() for m in ms}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ipi.launch(str(tmp_path_factory.mktemp("itd_parallel")))


def _case(runs, key, group=None):
    return runs[group or GROUP_OF[key]][key]


@pytest.mark.parametrize("mesh", MESHES)
def test_itd_matches_jax_and_one_process(runs, mesh):
    case = _case(runs, mesh)
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{ipi.MESHES[mesh][0]}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4  # the parameters moved


@pytest.mark.parametrize("mesh", MESHES)
def test_itd_replay_computes_on_the_shards(runs, mesh):
    calls = _case(runs, mesh)["info"]["calls"]
    counts = calls["counts"]
    # two windows of two micro-steps: the replays' calls, a micro-step, are
    # an eager step's forward and backward (no gather of the start state,
    # no whole-tensor optimizer step)
    assert calls["replays"] == ipi.ITERS // ipi.UNROLL and calls["child_steps"] == ipi.ITERS
    per_step = {k: n / calls["child_steps"] for k, n in counts["child"].items()}
    per_micro = {k: n / (calls["replays"] * calls["micro_steps"])
                 for k, n in counts["replay"].items()}
    assert per_micro == per_step, counts
    assert counts["replay"].get("all_reduce:batch", 0) > 0  # the gradients' batch mean
    # every optimizer step of a replay stepped this rank's parameters as held
    assert calls["stepped"] == [calls["held"]] * calls["replays"] * ipi.UNROLL
    if ipi.MESHES[mesh][1] == "sp":
        assert calls["held"] == calls["whole"]  # sp alone keeps every leaf whole
    else:
        assert calls["held"] < calls["whole"]


def test_itd_accumulation_clipping_and_grad_callback_match_jax(runs):
    case = runs["mdl2"]["flat_gas"]
    assert case["ok"], case["info"]
    ref = runs["ref_flat_gas"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4
    assert case["info"]["clip_effect"] > 1e-6  # the clipping changed the run


def test_itd_unroll_init_from_whole_meta_parameters_matches_jax(runs):
    """MAML under tp: the meta-parameters held whole, the classifier's
    shards cut from them through *f* where the replay starts."""
    case = runs["mdl2"]["maml"]
    assert case["ok"], case["info"]
    ref = runs["ref_maml"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4
    held = case["info"]["held"]
    assert held["classifier"] < held["meta"]  # shards of the meta-parameters' shapes


def test_itd_cut_mid_unroll_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["mdl2"]["resume"]
    assert case["ok"], case["info"]
    # the recorded start state saved whole, one batch of the window recorded
    assert case["info"]["saved_start_query_kernel"] == [16, 2, 8]
    assert case["info"]["recorded"] == 1


@pytest.mark.parametrize("mesh", ipi.COMPILED)
def test_itd_compiled_blocks_equal_driver(runs, mesh):
    case = _case(runs, f"compiled:{mesh}", GROUP_OF[mesh])
    assert case["ok"], case["info"]
