"""Meshes with three and four model axes: the mesh's arithmetic in process,
and ``dp:1,mdl:2,pp:2,sp:2`` (``m3pp``) on eight gloo ranks, in float64.

On ``m3pp`` the pipelined transformer (tests/test_composed.py's CFG, M 2)
under ``strategy="tp"`` with ``models.COMPOSED_SHARD_RULES`` computes
Megatron inside each GPipe stage over ``mdl x pp``, and the ``sp`` ranks
repeat that work, as the JAX package's ``make_pipelined_transformer``
does on such a mesh (it pipelines whenever the mesh has ``pp``). The JAX
references are the JAX package's sequential runs of the same programs
(its run on the mesh equals them: a repeating axis changes no value): the
forward and every gradient, darts and CG ``"jvp"`` within 1e-10, ITD
(tests/torch_itd_parallel_impl.py's ``pipe`` family) within 1e-10, each
within 1e-12 of the port's one-process run; compiled blocks and a run cut
at step 3 and auto-resumed equal driver mode and the uninterrupted run bit
for bit; a darts run makes no collective over ``sp`` and as many ``mdl``
all-reduces as the same program on ``dp:2,mdl:2,pp:2`` (the same eight
ranks; the dp axis changes only the batch groups); the ranks that differ
only in their ``sp`` coordinate hold bit-equal states. Tutorial 7's pp mode
runs on ``m3pp`` at small width: the JAX tutorial takes no such mesh, so it
is held to the JAX tutorial's program run sequentially at those widths
(``torch_three_axes_impl.run_ref_t7``, 1e-10) and to ``--mesh none``
(1e-12).

``tests/torch_three_axes_impl.py`` runs the ranks beside the four JAX
references: one launch for the file.
"""

import itertools
import math
import os
import sys

import numpy as np
import pytest
import torch

from betty_tpu_torch import EngineConfig, parallel
from betty_tpu_torch.models import (COMPOSED_SHARD_RULES, MOE_COMPOSED_SHARD_RULES,
                                    SP_COMPOSED_SHARD_RULES, make_pipelined_transformer)
from betty_tpu_torch.parallel.collectives import reduction_groups
from betty_tpu_torch.parallel.mesh import (MODEL_AXES, Cut, Mesh, check_axes, group_key,
                                           moe_local_dim, subset_ranks)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_pp_impl as ppi  # noqa: E402
import torch_three_axes_impl as ti  # noqa: E402

M3PP = (("dp", 1), ("mdl", 2), ("pp", 2), ("sp", 2))
# meshes whose model axes have unequal sizes, so a swapped stride shows
SHAPES = (M3PP,
          (("dp", 2), ("ep", 2), ("mdl", 3), ("pp", 2)),
          (("dp", 1), ("ep", 2), ("mdl", 2), ("pp", 2), ("sp", 2)),
          (("dcn", 2), ("dp", 1), ("mdl", 2), ("sp", 3), ("ep", 2)),
          (("dp", 3), ("sp", 2), ("pp", 1), ("mdl", 2)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ti.launch(str(tmp_path_factory.mktemp("three_axes")), ["m3pp"])


# ---------------------------------------------------------------------------
# in process: coordinates, views, groups, layouts
# ---------------------------------------------------------------------------


def _coords(axes, rank):
    """Each axis's coordinate of ``rank``, row-major, the last axis innermost."""
    return dict(zip([n for n, _ in axes], np.unravel_index(rank, [s for _, s in axes])))


def _subsets(model):
    return [c for r in range(1, len(model) + 1) for c in itertools.combinations(model, r)]


@pytest.mark.parametrize("axes", SHAPES, ids=lambda a: ",".join(f"{n}:{s}" for n, s in a))
def test_coordinates_views_and_over_every_subset(axes):
    """Every rank's coordinates, and ``over`` of every subset of the model
    axes (``view`` of one): its size, its index (row-major over the subset
    in the mesh's order), its axis, its batch coordinates."""
    world = math.prod(s for _, s in axes)
    model = [n for n, _ in axes if n in MODEL_AXES]
    for rank in range(world):
        mesh = Mesh(axes, rank=rank, world=world)
        c = _coords(axes, rank)
        batch = [n for n, _ in axes if n not in MODEL_AXES]
        b = int(np.ravel_multi_index([c[n] for n in batch], [mesh.shape[n] for n in batch]))
        assert (mesh.batch_index, mesh.batch_world) == (b, world // mesh.model_size)
        assert all(mesh.axis_index(a) == c[a] for a in model)
        assert mesh.model_axis is None and mesh.model_size == math.prod(mesh.shape[a]
                                                                         for a in model)
        for subset in _subsets(model):
            view = mesh.over(tuple(reversed(subset)))  # any order: the mesh's is taken
            idx = int(np.ravel_multi_index([c[a] for a in subset],
                                           [mesh.shape[a] for a in subset]))
            assert (view.model_size, view.model_index) == \
                (math.prod(mesh.shape[a] for a in subset), idx), (rank, subset)
            assert (view.batch_index, view.batch_world) == (mesh.batch_index, mesh.batch_world)
            assert view.model_axis == (subset[0] if len(subset) == 1 else None)
            if len(subset) == 1:
                assert mesh.view(subset[0]) is view and view.view(subset[0]) is view
            assert view.over(model).model_index == mesh.model_index
        assert mesh.over(model) is mesh and mesh.over(()) is mesh


@pytest.mark.parametrize("axes", SHAPES, ids=lambda a: ",".join(f"{n}:{s}" for n, s in a))
def test_subset_groups_match_a_brute_force_enumeration(axes):
    """``subset_ranks`` against every rank's coordinates: a group is the
    ranks that agree on every axis but the subset's, in ascending order, one
    group for each such coordinate; they split the world, and a rank's
    place in its group is its ``over(subset).model_index``."""
    world = math.prod(s for _, s in axes)
    model = [n for n, _ in axes if n in MODEL_AXES]
    coords = [_coords(axes, r) for r in range(world)]
    for subset in _subsets(model):
        groups = subset_ranks(axes, subset)
        fixed = [n for n, _ in axes if n not in subset]
        want = {}
        for r, c in enumerate(coords):
            want.setdefault(tuple(c[n] for n in fixed), []).append(r)
        assert sorted(map(tuple, groups)) == sorted(map(tuple, want.values()))
        assert len(groups) == world // math.prod(dict(axes)[a] for a in subset)
        for g in groups:
            assert g == sorted(g)
            for r in g:
                assert g[Mesh(axes, rank=r, world=world).over(subset).model_index] == r
    assert subset_ranks(M3PP, ("pp", "mdl"))[1] == [1, 3, 5, 7]  # sp 1: mdl x pp


def test_over_takes_the_subsets_group_and_names_it():
    """A pair's view carries the pair's group (``axis_groups["mdl+pp"]``),
    not the whole model group, so a sum over a cut's axes leaves the
    repeating ``sp`` ranks out; the whole set is ``"model"``."""
    mesh = Mesh(M3PP, rank=5, world=8)
    model = mesh.model_axes
    keys = [group_key(s, mesh) for s in _subsets(model)]
    assert keys == ["mdl", "pp", "sp", "mdl+pp", "mdl+sp", "pp+sp", "model"]
    mesh.axis_groups.update({k: f"g_{k}" for k in keys})
    assert mesh.over(("pp", "mdl")).model_group == "g_mdl+pp"
    assert mesh.view("sp").model_group == "g_sp"
    assert mesh.view("mdl").over(("sp", "pp")).model_group == "g_pp+sp"
    assert mesh.view("pp").over(model).model_group == "g_model"
    assert mesh.over(("mdl", "pp")) is mesh.view("sp").over(("mdl", "pp"))  # one cache
    with parallel.active(mesh):
        assert parallel.mesh.tp_mesh().model_group == "g_mdl"
        assert parallel.mesh.axis_mesh("pp").model_group == "g_pp"
    four = Mesh((("dp", 1), ("ep", 2), ("mdl", 2), ("pp", 2), ("sp", 2)),
                rank=0, world=16)
    assert [group_key(s, four) for s in (("ep", "mdl"), ("ep", "mdl", "pp", "sp"))] == \
        ["ep+mdl", "model"]
    # the MoE's pair beside the ranks that repeat it: experts and columns
    assert moe_local_dim("moe/w1", four) == Cut(((0, "ep"), (2, "mdl")))
    assert moe_local_dim("moe/b2", four) == Cut(((0, "ep"),))


@pytest.mark.parametrize("shape", [
    M3PP, (("dp", 1), ("mdl", 2), ("sp", 2), ("ep", 2)), (("dp", 1), ("ep", 2), ("mdl", 2),
                                                          ("pp", 2)),
    (("dp", 1), ("ep", 2), ("mdl", 2), ("pp", 2), ("sp", 2)),
    (("dcn", 2), ("dp", 1), ("sp", 2), ("pp", 2), ("mdl", 2), ("ep", 2))])
def test_three_and_four_model_axes_are_accepted(shape):
    assert EngineConfig(strategy="tp", mesh_shape=shape).mesh_shape == shape
    check_axes(shape)
    for bad in (shape + (("mdl", 2),), (("mdl", 2),) + shape, shape + (("tp", 2),)):
        with pytest.raises(ValueError):
            check_axes(bad)


def test_three_axis_layouts_cut_each_leaf_on_its_axes_alone():
    """On ``m3pp`` the composed rules cut the stacked leaves over ``pp``
    and ``mdl`` and leave ``sp`` out: the two ranks of an ``sp`` pair hold
    the same shards, and a sum over a leaf's cut axes is grouped by them."""
    params = make_pipelined_transformer(None, vocab_size=64, max_len=8, dim=16, depth=4,
                                        heads=2).variables["params"]
    shards = {}
    for rank in range(8):
        mesh = Mesh(M3PP, rank=rank, world=8)
        dims = parallel.state_shard_dims({"params": params}, mesh, "tp",
                                         rules=COMPOSED_SHARD_RULES)["params"]
        assert dims["blocks.attn.query.kernel"] == Cut(((0, "pp"), (2, "mdl")))
        assert dims["blocks.ln1.weight"] == Cut(((0, "pp"),)) and dims["embed.tok"] is None
        shards[rank] = parallel.mesh.shard_tree(params, dims, mesh, "model")
        groups = reduction_groups(params, dims, mesh)
        assert set(groups) == {("mdl", "pp"), ("pp",), ()} and list(groups)[-1] == ()
    for rank in range(0, 8, 2):  # rank = mdl x 4 + pp x 2 + sp
        assert all(torch.equal(shards[rank][k], shards[rank + 1][k]) for k in params)
    q = params["blocks.attn.query.kernel"]
    assert torch.equal(shards[6]["blocks.attn.query.kernel"], q[2:4, :, 1:2])  # mdl 1, pp 1
    sp = Mesh((("dp", 1), ("mdl", 2), ("sp", 2), ("ep", 2)), rank=3, world=8)
    dims = parallel.state_shard_dims({"params": params}, sp, "tp",
                                     rules=SP_COMPOSED_SHARD_RULES)["params"]
    assert dims["blocks.attn.query.kernel"] == Cut(((2, "mdl"),))
    moe = Mesh((("dp", 1), ("ep", 2), ("mdl", 2), ("pp", 2)), rank=5, world=8)
    w = {"moe": {"w1": torch.zeros(4, 8, 16), "b2": torch.zeros(4, 8)}}
    dims = parallel.state_shard_dims({"params": w}, moe, "tp",
                                     rules=MOE_COMPOSED_SHARD_RULES)["params"]["moe"]
    assert dims == {"w1": Cut(((0, "ep"), (2, "mdl"))), "b2": Cut(((0, "ep"),))}


# ---------------------------------------------------------------------------
# m3pp on eight gloo ranks
# ---------------------------------------------------------------------------


def test_m3pp_forward_and_gradients_match_jax(runs):
    ref, got = runs["ref_darts"], runs["m3pp"]["forward"]
    assert ppi.err(got["logits"], ref["logits"]) <= 1e-10
    assert set(got["grads"]) == set(ref["grads"])
    errs = {k: ppi.err(got["grads"][k], v) for k, v in ref["grads"].items()}
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert min(ppi.err(got["grads"][k], 0.0) for k in
               ("blocks.attn.query.kernel", "blocks.fc2.weight", "embed.tok")) > 1e-6
    info = got["info"]
    # sharded_norm counts every element once (the sp ranks' copies left out);
    # M + S - 1 ring shifts a forward over pp, no sequence gather
    assert abs(info["norm"] - info["whole_norm"]) <= 1e-12 * info["whole_norm"]
    assert info["calls"] == {"ring_shift": 2 + 2 - 1}
    assert info["held"]["blocks.attn.query.kernel"] == [2, 16, 1, 8]


@pytest.mark.parametrize("program", ti.M3PP_PROGRAMS)
def test_m3pp_programs_match_jax_sequential_and_one_process(runs, program):
    case = runs["m3pp"][program]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{program.split(':')[1]}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4


def test_m3pp_itd_matches_jax_sequential_and_one_process(runs):
    case = runs["m3pp"]["itd"]
    assert case["ok"], case["info"]
    ref = runs["ref_itd_pipe"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4


def test_m3pp_compiled_blocks_equal_driver(runs):
    case = runs["m3pp"]["compiled"]
    assert case["ok"], case["info"]


def test_m3pp_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["m3pp"]["resume"]
    assert case["ok"], case["info"]
    # the checkpoint holds whole tensors, gathered over mdl and pp
    assert case["info"]["saved"] == {"blocks.attn.query.kernel": [4, 16, 2, 8],
                                     "blocks.fc2.weight": [4, 16, 64]}
    assert case["info"]["moments"]["blocks.attn.query.kernel"] == [[2, 16, 1, 8]] * 2


def test_m3pp_makes_no_sp_collective_and_the_mdl_all_reduces_of_two_axes(runs):
    counts = runs["m3pp"]["calls"]["info"]["counts"]
    three, two = counts[ti.M3PP], counts[ti.M3PP_WITHOUT_SP]
    assert not [k for k in three if "sp" in k.split(":")[1]], three
    assert three["all_reduce:mdl"] == two["all_reduce:mdl"] > 0
    assert three["batch_isend_irecv:pp"] == two["batch_isend_irecv:pp"] > 0
    # the norm of the leaves cut over mdl and pp: over their pair's group on
    # three axes, over the whole model group on two
    assert three.get("all_reduce:mdl+pp") == two.get("all_reduce:model") > 0
    assert "all_reduce:model" not in three and sum(three.values()) == sum(two.values())


def test_m3pp_sp_replicas_hold_bit_equal_states(runs):
    info = runs["m3pp"]["calls"]["info"]
    assert info["sp_replicas_equal"], info
    assert info["distinct_states"] == 4  # one a (mdl, pp) coordinate


def test_tutorial_7_runs_the_three_axis_mesh(runs):
    case = runs["m3pp"]["tutorial"]
    assert case["ok"], case["info"]  # against --mesh none, 1e-12
    assert case["info"]["held"] == [2, 16, 1, 8] and case["info"]["strategy"] == "tp"
    ref = runs["ref_t7"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-6  # AdamW 1e-4, 3 steps
