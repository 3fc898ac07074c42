"""Tensor parallelism of the port (``EngineConfig(strategy="tp")``,
``betty_tpu_torch/parallel``) on the CPU over gloo, in float64.

* Layouts: for every leaf of the transformer at tests/test_tp.py's
  BASE_ARGS widths and at RoBERTa-large's, the port's shard dim
  (``parallel.tp_shardings`` on the port's names) is the axis of the same
  tensor that the JAX package's ``tp_shardings`` shards, at ``mdl`` 2 and
  4; shapes only (``jax.eval_shape``, meta tensors). The quirks the JAX
  rules give are pinned by name, and a ``shard_rules`` override wins as in
  ``tests/test_tp.py::test_tp_user_shard_rules_override``.
* The bert program at BASE_ARGS (dropout 0, 4 iterations, unshuffled) on 2
  ranks (``dp:1,mdl:2``) and 4 (``dp:2,mdl:2``) for darts, SAMA, CG (plain
  and fused) and Neumann: within 1e-10 of the JAX package's unsharded run
  and 1e-12 of the port's one-process run.
* At dropout 0.1 tp equals the port's one-process run; each rank holds
  1/2 of the query kernel and of its Adam moments; an update makes
  model-axis all-reduces, a forward two a block and one gather; compiled
  blocks equal driver mode; a run cut mid-unroll and auto-resumed equals
  the uninterrupted one, its checkpoint holding whole tensors; the hooks
  (``grad_callback``, ``param_callback``) see whole tensors, as in one
  process.

``tests/torch_tp_impl.py`` runs the JAX references (one process a solver)
and the two groups of ranks side by side, each with a timeout.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from betty_tpu_torch import parallel
from betty_tpu_torch.models import TransformerClassifier
from betty_tpu_torch.parallel.mesh import Mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_parallel import _env, _err, _free_port  # noqa: E402

IMPL = os.path.join(HERE, "torch_tp_impl.py")
TIMEOUT = 300
JAX_SOLVERS = ("darts", "sama", "cg", "neumann")
SOLVERS = ("darts", "sama", "cg", "cg_fused", "neumann")
GROUPS = {"mdl2": 2, "dp2mdl2": 4}


def launch(work, refs, groups):
    """Start the reference processes (``(mode, name, args)``) and the rank
    groups, wait for all of them (any failure or timeout fails) and load
    their JSON results."""
    procs = []
    for mode, name, args in refs:
        procs.append((name, subprocess.Popen(
            [sys.executable, IMPL, mode, str(work / f"{name}.json")] + list(args),
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for group, world in groups.items():
        port = _free_port()
        for rank in range(world):
            env = _env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append((f"{group} rank {rank}", subprocess.Popen(
                [sys.executable, IMPL, "rank", str(work / f"{group}.json"), str(work), group],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs = {}
    try:
        for name, p in procs:
            outputs[name] = p.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        pytest.fail(f"{name} timed out after {TIMEOUT} s")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs:
        assert p.returncode == 0, f"{name} failed:\n{outputs[name][-4000:]}"
    out = {}
    for name in [n for _, n, _ in refs] + list(groups):
        with open(work / f"{name}.json") as fh:
            out[name] = json.load(fh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    return launch(work, [("ref", f"ref_{s}", [s]) for s in JAX_SOLVERS], GROUPS)


def _tree_err(got, want):
    errs = {f"{n}/{k}": _err(got[n][k], v) for n in want for k, v in want[n].items()}
    assert all(set(got[n]) == set(want[n]) for n in want)
    return max(errs.values()), sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_tp_bert_matches_jax_unsharded_and_one_process(runs, group, solver):
    case = runs[group][f"tp:{solver}"]
    assert case["ok"], case["info"]  # against the port's one-process run, 1e-12
    ref = runs[f"ref_{solver.replace('_fused', '')}"]
    err, worst = _tree_err(case["params"], ref["final"])
    assert err <= 1e-10, worst
    assert _tree_err(case["params"], ref["init"])[0] > 1e-4  # the parameters moved


def test_tp_dropout_draws_the_unsharded_masks(runs):
    case = runs["mdl2"]["dropout"]
    assert case["ok"], case["info"]


def test_tp_ranks_hold_shards_and_make_model_axis_collectives(runs):
    info = runs["mdl2"]["sharding"]["info"]
    held, dims = info["held"], info["dims"]
    # 1/2 of the (64, 4, 16) query kernel, its Adam moments alike
    assert held["blocks.0.attn.query.kernel"] == [64, 2, 16]
    assert info["opt_held"]["blocks.0.attn.query.kernel"] == [64, 2, 16]
    assert held["blocks.0.fc1.weight"] == [128, 64] and held["blocks.0.fc2.weight"] == [64, 128]
    assert held["embed.weight"] == [500, 64]
    assert held["blocks.0.ln1.weight"] == [64] and dims["blocks.0.ln1.weight"] is None
    # a forward: one row-parallel sum after the attention and one after the
    # MLP a block, and one gather of the leaves used whole
    assert info["forward_collectives"] == {"all_reduce:model": 4,
                                           "all_gather_into_tensor:model": 1}
    # an update: those, and f's sums in the backward
    assert info["update_collectives"]["all_reduce:model"] >= 8, info["update_collectives"]


def test_tp_hooks_see_whole_tensors(runs):
    """grad_callback and param_callback see whole tensors under tp (norms over
    whole trees, an edit across the sharded heads axis), as in one process."""
    case = runs["mdl2"]["hooks"]
    assert case["ok"], case["info"]
    assert case["info"]["shapes"] == [[64, 4, 16]]


def test_tp_compiled_blocks_equal_driver(runs):
    case = runs["mdl2"]["compiled"]
    assert case["ok"], case["info"]


def test_tp_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["mdl2"]["resume"]
    assert case["ok"], case["info"]
    assert case["info"]["saved_query_kernel"] == [64, 4, 16]  # the checkpoint holds whole tensors


# ---------------------------------------------------------------------------
# layouts, against the JAX package's tp_shardings (shapes only)
# ---------------------------------------------------------------------------

WIDTHS = {  # BASE_ARGS (the small model's vocabulary of 1000) and RoBERTa-large
    "base": dict(vocab_size=1000, max_len=16, dim=64, depth=2, heads=4),
    "large": dict(vocab_size=50265, max_len=128, dim=1024, depth=24, heads=16),
}


def _flax_name(path):
    """The port's name of a flax ``TransformerClassifier`` leaf and whether
    the port holds it transposed (``nn.Linear``)."""
    keys = [str(getattr(k, "key", k)) for k in path]
    top = {"Embed_0": "embed.weight", "pos_embedding": "pos_embedding"}
    if keys[0] in top:
        return top[keys[0]], False
    field = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if keys[0].startswith("EncoderBlock_"):
        pre = f"blocks.{keys[0].split('_')[1]}"
        sub = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2", "Dense_0": "fc1", "Dense_1": "fc2"}
        if keys[1] == "MultiHeadDotProductAttention_0":
            return f"{pre}.attn.{keys[2]}.{keys[3]}", False
        return f"{pre}.{sub[keys[1]]}.{field[keys[2]]}", keys[2] == "kernel"
    sub = {"LayerNorm_0": "ln_f", "Dense_0": "pool", "Dense_1": "head"}
    return f"{sub[keys[0]]}.{field[keys[1]]}", keys[1] == "kernel"


def _jax_dims(width, mdl):
    """``{port name: dim}`` of the JAX package's ``tp_shardings`` at
    ``dp:8/mdl,mdl:mdl``, mapped onto the port's tensors."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from betty_tpu.models import TransformerClassifier as JTransformer
    from betty_tpu.parallel import tp_shardings as jax_tp_shardings

    cfg = WIDTHS[width]
    model = JTransformer(**cfg, num_classes=2)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((2, cfg["max_len"]), jnp.int32),
                                               train=False))["params"]
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(8 // mdl, mdl), ("dp", "mdl"))
    specs = jax_tp_shardings(shapes, jmesh)
    out, jshapes = {}, {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name, transposed = _flax_name(path)
        spec = tuple(sh.spec)
        d = spec.index("mdl") if "mdl" in spec else None
        out[name] = (1 - d) if transposed and d is not None else d
    for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name, transposed = _flax_name(path)
        jshapes[name] = tuple(reversed(x.shape)) if transposed else tuple(x.shape)
    return out, jshapes


def _port_dims(width, mdl, rules=None):
    cfg = WIDTHS[width]
    model = TransformerClassifier(**cfg, num_classes=2, device="meta")
    params = dict(model.named_parameters())
    mesh = Mesh((("dp", 8 // mdl), ("mdl", mdl)), rank=0, world=8)
    return parallel.tp_shardings(params, mesh, rules=rules), params


@pytest.mark.parametrize("mdl", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_tp_layout_matches_jax_leaf_by_leaf(width, mdl):
    want, jshapes = _jax_dims(width, mdl)
    got, params = _port_dims(width, mdl)
    assert set(got) == set(want)
    for name, p in params.items():
        assert tuple(p.shape) == jshapes[name], name
    bad = {n: (got[n], want[n]) for n in want if got[n] != want[n]}
    assert not bad, bad


@pytest.mark.parametrize("mdl", [2, 4])
def test_tp_layout_quirks_at_roberta_large(mdl):
    dims, _ = _port_dims("large", mdl)
    b = "blocks.0."
    for name in ("query", "key", "value"):
        assert dims[f"{b}attn.{name}.kernel"] == 1       # heads
        assert dims[f"{b}attn.{name}.bias"] == 1         # (H, Dh): Dh, not heads
    assert dims[f"{b}attn.out.kernel"] == 0 and dims[f"{b}attn.out.bias"] is None
    assert dims["embed.weight"] == 1                     # vocab 50,265 is odd: d instead
    assert dims[f"{b}fc1.weight"] == 0 and dims[f"{b}fc2.weight"] == 1
    assert dims[f"{b}fc1.bias"] == 0                     # 4,096 elements: sharded
    assert dims[f"{b}fc2.bias"] is None                  # 1,024: replicated
    assert dims["head.weight"] is None and dims["head.bias"] is None  # (2, 1024)
    assert dims["pool.weight"] == 1                      # square: flax's "in" axis
    assert dims["pos_embedding"] == 2 and dims[f"{b}ln1.weight"] is None


def test_tp_shard_rules_override():
    """``tests/test_tp.py::test_tp_user_shard_rules_override`` on the port."""
    mesh = Mesh((("dp", 2), ("mdl", 4)), rank=0, world=8)
    tree = {"Dense_0": {"kernel": torch.zeros(64, 256)}, "tiny": torch.zeros(8)}
    dims = parallel.tp_shardings(tree, mesh, rules=((r"Dense_0/kernel$", ("mdl", None)),))
    assert dims["Dense_0"]["kernel"] == 0  # the user's rule wins over the largest dim
    assert dims["tiny"] is None
    assert parallel.tp_shardings(tree, mesh)["Dense_0"]["kernel"] == 1
    # a rule that does not fit falls through to the defaults; a port layout
    # it cannot hold raises
    odd = {"w": torch.zeros(6, 4096)}
    assert parallel.tp_shardings(odd, mesh, rules=((r"w$", ("mdl", None)),))["w"] == 1
    with pytest.raises(ValueError, match="one dim"):
        parallel.tp_shardings(tree, mesh, rules=((r"kernel$", ("dp", "mdl")),))
    # the transformer's rules search the port's names
    dims, _ = _port_dims("base", 2, rules=((r"attn\.query\.kernel$", ()),))
    assert dims["blocks.0.attn.query.kernel"] is None
    assert dims["blocks.0.attn.key.kernel"] == 1
    assert re.search(parallel.mesh.MOE_EXPERT_LEAF, "moe/w1")
