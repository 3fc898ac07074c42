"""The composed ``dp x mdl x pp`` mesh of the port (``EngineConfig(strategy=
"tp", mesh_shape=(("dp", N), ("mdl", 2), ("pp", 2)))`` with
``models.COMPOSED_SHARD_RULES``: the stacked attention kernels cut on the
stage dim over ``pp`` and on heads over ``mdl``, the stacked MLP column-
then row-parallel, the other stacked leaves on ``pp``) on the CPU over
gloo, in float64.

The JAX package's sequential ``make_pipelined_transformer`` at
tests/test_composed.py's CFG runs tests/test_composed.py:230-262's bilevel
program (darts, and CG in both HVP modes); the port's ranks run it on
``mdl2pp2`` (``dp:1,mdl:2,pp:2``, 4 ranks, M 2) and ``dp2mdl2pp2``
(``dp:2,mdl:2,pp:2``, 8 ranks, M 2): the forward and every gradient, the
programs within 1e-10 of JAX and 1e-12 of the port's one-process run,
``sharded_norm`` of the gradient shards against the whole norm; on
``mdl2pp2`` also CG through the fused vector loop, ``strategy="pp"`` (the
blocks whole over ``mdl``), the shards and Adam moments held, compiled
blocks against driver mode and a run cut and auto-resumed, bit for bit. In
process: the layouts, the mesh's coordinates and views, the (dp, pp, ep)
replication of tests/test_composed.py:285-306 and the meshes with three
model axes accepted.

``tests/torch_composed_impl.py`` runs the ranks; the JAX references are
``tests/torch_pp_impl.py``'s, started side by side with them (one launch
for the file).
"""

import os
import sys

import pytest
import torch

from betty_tpu_torch import EngineConfig, parallel
from betty_tpu_torch.models import COMPOSED_SHARD_RULES, make_pipelined_transformer
from betty_tpu_torch.parallel.mesh import Cut, Mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_composed_impl as ci  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402
from torch_parallel_impl import world_of_one  # noqa: E402

GROUPS = tuple(ci.GROUPS)
CASES = [(g, p) for g in GROUPS for p in ci.GROUP_PROGRAMS[g]]
COMPOSED = (("dp", 2), ("mdl", 2), ("pp", 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ci.launch(str(tmp_path_factory.mktemp("composed")))


@pytest.mark.parametrize("group", GROUPS)
def test_composed_forward_and_gradients_match_jax(runs, group):
    ref, got = runs["ref_darts"], runs[group]["forward"]
    assert ppi.err(got["logits"], ref["logits"]) <= 1e-10
    assert set(got["grads"]) == set(ref["grads"])
    errs = {k: ppi.err(got["grads"][k], v) for k, v in ref["grads"].items()}
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    # the two-dim shards' gradients (held above, gathered over both axes) are not 0
    assert min(ppi.err(got["grads"][k], 0.0) for k in
               ("blocks.attn.query.kernel", "blocks.fc2.weight", "embed.tok")) > 1e-6


@pytest.mark.parametrize("group,program", CASES)
def test_composed_programs_match_jax_sequential_and_one_process(runs, group, program):
    case = runs[group][program]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    solver = ci.PROGRAMS[program][1]
    ref = runs[f"ref_{solver}"]
    assert ppi.tree_err(case["params"], ref["final"]) <= 1e-10
    assert ppi.tree_err(case["params"], ref["init"]) > 1e-4  # the parameters moved


@pytest.mark.parametrize("group", GROUPS)
def test_composed_sharded_norm_counts_every_element_once(runs, group):
    info = runs[group]["forward"]["info"]
    assert abs(info["norm"] - info["whole_norm"]) <= 1e-12 * info["whole_norm"]
    # M + S - 1 ring shifts a forward over the pp group, as on a pp mesh
    assert info["calls"] == {"ring_shift": 2 + 2 - 1}


def test_composed_ranks_hold_two_dim_shards_and_their_moments(runs):
    held = runs["mdl2pp2"]["forward"]["info"]["held"]
    # (depth, d, H, Dh) = (4, 16, 2, 8): stage dim depth/2, heads H/2
    assert held["blocks.attn.query.kernel"] == [2, 16, 1, 8]
    assert held["blocks.attn.out.kernel"] == [2, 1, 8, 16]
    assert held["blocks.fc1.weight"] == [2, 32, 16] and held["blocks.fc2.weight"] == [2, 16, 32]
    # the q/k/v and fc1 biases and the LayerNorms on pp alone; the rest whole
    assert held["blocks.attn.query.bias"] == [2, 2, 8] and held["blocks.fc1.bias"] == [2, 64]
    assert held["embed.tok"] == [64, 16] and held["head.pool_w"] == [16, 16]
    resume = runs["mdl2pp2"]["resume"]["info"]
    assert resume["held"]["blocks.attn.query.kernel"] == [2, 16, 1, 8]
    assert resume["moments"]["blocks.attn.query.kernel"] == [[2, 16, 1, 8]] * 2  # mu, nu
    assert all(resume["moments"][k] == [v] * 2 for k, v in resume["held"].items())


def test_composed_compiled_blocks_equal_driver(runs):
    case = runs["mdl2pp2"]["compiled"]
    assert case["ok"], case["info"]


def test_composed_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["mdl2pp2"]["resume"]
    assert case["ok"], case["info"]
    # the checkpoint holds whole tensors, gathered over both axes
    assert case["info"]["saved"] == {"blocks.attn.query.kernel": [4, 16, 2, 8],
                                     "blocks.fc2.weight": [4, 16, 64]}


# ---------------------------------------------------------------------------
# in process: layouts, the mesh, the meshes of three model axes
# ---------------------------------------------------------------------------


def _stacked_params():
    return make_pipelined_transformer(None, vocab_size=64, max_len=8, dim=16, depth=4,
                                      heads=2).variables["params"]


def test_composed_rules_cut_two_dims_and_the_moments_alike():
    params = _stacked_params()
    state = {"params": params, "opt_state": {"count": 0, "mu": params, "nu": params}}
    mesh = Mesh(COMPOSED, rank=5, world=8)
    dims = parallel.state_shard_dims(state, mesh, "tp", rules=COMPOSED_SHARD_RULES)
    p = dims["params"]
    assert p["blocks.attn.query.kernel"] == Cut(((0, "pp"), (2, "mdl")))
    assert p["blocks.attn.out.kernel"] == Cut(((0, "pp"), (1, "mdl")))
    assert p["blocks.fc1.weight"] == Cut(((0, "pp"), (1, "mdl")))
    assert p["blocks.fc2.weight"] == Cut(((0, "pp"), (2, "mdl")))
    assert p["blocks.ln1.weight"] == p["blocks.attn.query.bias"] == Cut(((0, "pp"),))
    assert p["embed.tok"] is None and p["head.pool_w"] is None
    assert dims["opt_state"]["mu"] == p and dims["opt_state"]["count"] is None
    # rank 5 is (dp 1, mdl 0, pp 1): stage 1's blocks, head chunk 0
    shard = parallel.mesh.shard_tree(params, p, mesh, "model")
    q = params["blocks.attn.query.kernel"]
    assert torch.equal(shard["blocks.attn.query.kernel"], q[2:4, :, 0:1])
    assert torch.equal(shard["blocks.fc2.weight"], params["blocks.fc2.weight"][2:4, :, :32])
    whole = parallel.mesh.full_shape_like(shard, p, mesh, "model")
    assert all(whole[k].shape == v.shape for k, v in params.items())
    # strategy "pp" on the composed mesh: the stacked blocks on pp alone
    pp = parallel.state_shard_dims(state, mesh, "pp")["params"]
    assert pp["blocks.attn.query.kernel"] == Cut(((0, "pp"),)) and pp["embed.tok"] is None


def test_composed_mesh_coordinates_and_views():
    """Row-major ranks, the last axis innermost: rank = (dp x mdl + mdl
    index) x pp + pp index; a view sees one axis."""
    for rank in range(8):
        mesh = Mesh(COMPOSED, rank=rank, world=8)
        b, i, j = rank // 4, (rank // 2) % 2, rank % 2
        assert (mesh.batch_index, mesh.batch_world) == (b, 2)
        assert (mesh.model_index, mesh.model_size, mesh.model_axis) == (2 * i + j, 4, None)
        assert (mesh.axis_index("mdl"), mesh.axis_index("pp")) == (i, j)
        mesh.axis_groups.update({"mdl": "g_mdl", "pp": "g_pp", "model": "g_model"})
        mdl, pp = mesh.view("mdl"), mesh.view("pp")
        assert (mdl.model_axis, mdl.model_size, mdl.model_index, mdl.model_group) == \
            ("mdl", 2, i, "g_mdl")
        assert (pp.model_axis, pp.model_size, pp.model_index, pp.model_group) == \
            ("pp", 2, j, "g_pp")
        assert (pp.batch_index, pp.batch_world) == (b, 2) and mdl.view("pp") is pp
        assert mdl.over(("mdl", "pp")).model_group == "g_model"
    flat = Mesh((("dp", 2), ("mdl", 4)), rank=5, world=8)
    assert flat.view("mdl") is flat and (flat.model_index, flat.batch_index) == (1, 1)
    with parallel.active(Mesh(COMPOSED, rank=0, world=8, axis_groups={"mdl": 1, "pp": 2})):
        assert parallel.mesh.tp_mesh().model_axis == "mdl"
        assert parallel.mesh.axis_mesh("pp").model_axis == "pp"
        assert parallel.mesh.axis_mesh("sp") is None


def test_composed_specs_name_each_model_axis_once():
    mesh = Mesh(COMPOSED, rank=0, world=8)
    x = {"w": torch.zeros(4, 8, 6)}
    for spec in (("mdl", "mdl", None), ("dp", None, "mdl"), (("mdl", "pp"), None, None)):
        with pytest.raises(ValueError, match="each named once"):
            parallel.tp_shardings(x, mesh, rules=((r"w", spec),))
    # a spec that does not divide falls through to the next rule
    assert parallel.tp_shardings(x, mesh, rules=((r"w", (None, None, "mdl", "pp")),
                                                 (r"w", ("pp", "mdl")))) == \
        {"w": Cut(((0, "pp"), (1, "mdl")))}


def test_strategy_pp_ep_replicate_non_matching_problems():
    """tests/test_composed.py:285-306 on the port: on a (dp, pp, ep) mesh a
    problem without the pp or ep layout stays replicated."""
    mesh = Mesh((("dp", 2), ("pp", 2), ("ep", 2)), rank=3, world=8)
    state = {"params": {"Dense_0": {"kernel": torch.ones(128, 64)}},
             "opt_state": {"mu": {"Dense_0": {"kernel": torch.zeros(128, 64)}}}}
    for strategy in ("pp", "ep"):
        assert parallel.state_shard_dims(state, mesh, strategy) == {}
        out = parallel.shard_state(dict(state), mesh, strategy)
        assert out["params"]["Dense_0"]["kernel"] is state["params"]["Dense_0"]["kernel"]
    assert EngineConfig(strategy="ep", mesh_shape=mesh.axes).mesh_shape == mesh.axes


def test_uncomputed_compositions_raise_naming_the_roadmap():
    """Three and four model axes are accepted (``EngineConfig``,
    ``check_axes``; tests/test_torch_three_axes*.py and
    test_torch_four_axes.py hold their values on eight and sixteen ranks),
    and a malformed mesh still raises ``ValueError``; a one-process
    ``make_mesh`` of such a mesh can only say that it does not cover the
    world. A module built for ``sp`` beside a second model axis and the MoE
    beside one build and run (tests/test_torch_composed_sp_moe.py holds
    their values), and an ITD replay on two model axes runs
    (tests/test_torch_itd_parallel.py holds its values on the shards);
    nothing falls back."""
    from betty_tpu_torch import optim
    from betty_tpu_torch.models import init_moe_params, moe_ffn
    from betty_tpu_torch.module import from_fn
    from betty_tpu_torch.problems.iterative import IterativeProblem, unroll_data

    for sp_mesh in ((("dp", 1), ("mdl", 2), ("sp", 2)), (("dp", 1), ("pp", 2), ("sp", 2))):
        module = make_pipelined_transformer(sp_mesh, vocab_size=64, max_len=8, dim=16, depth=2,
                                            heads=2, seq_axis="sp")
        assert module.local_dims  # the blocks it computes on as cuts
    params = init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4)
    # experts whole on every rank of the (dp, pp, ep) mesh: the one-rank
    # path, no collective
    with parallel.active(Mesh((("dp", 1), ("pp", 2), ("ep", 2)), rank=0, world=4)):
        y, _ = moe_ffn(params, torch.randn(16, 8))
    assert y.shape == (16, 8)
    for shape in ((("dp", 1), ("mdl", 2), ("pp", 2), ("sp", 2)),
                  (("dp", 1), ("mdl", 2), ("ep", 2), ("pp", 2))):
        assert EngineConfig(strategy="tp", mesh_shape=shape).mesh_shape == shape
        parallel.mesh.check_axes(shape)
        with pytest.raises(ValueError, match="different model axes"):
            EngineConfig(strategy="tp", mesh_shape=shape + (("pp", 2),))
        with world_of_one():
            with pytest.raises(ValueError, match="does not cover"):
                parallel.make_mesh(shape)

    class Inner(IterativeProblem):
        def training_step(self, batch):
            return 0.5 * torch.sum((self.module() - batch) ** 2)

    # a replay of two SGD steps on the composed mesh (its leaf replicated,
    # its loss bound to the mesh, no collective): differentiable in the start
    inner = Inner("inner", module=from_fn(lambda p: p["w"], {"w": torch.zeros(3)}),
                  optimizer=optim.sgd(lr=0.1))
    inner._engine = type("E", (), {"mesh": Mesh(COMPOSED, rank=0, world=8)})()
    inner.module_fn = inner._user_module
    w0 = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    target = torch.tensor([0.0, 1.0, -1.0])
    start = {"params": {"w": w0}, "opt_state": inner.optimizer.init({"w": w0}), "sched_step": 0,
             "extra": {}}
    out = inner.replay_unroll({"inner": {"params": {"w": w0}, "extra": {}}},
                              unroll_data(start, 0, [target, target]))["w"]
    assert torch.allclose(out, target + 0.81 * (w0 - target))
    (g,) = torch.autograd.grad(out.sum(), w0)
    assert torch.allclose(g, torch.full((3,), 0.81))
