"""The port's data-parallel strategies (``betty_tpu_torch/parallel``) on the
CPU, over gloo, in float64.

* Against the JAX package's one-process run on the global batch
  (``tests/test_multihost.py::_single_process_reference``'s construction:
  unshuffled loaders, each rank loading half of each global batch of 32): the
  fixtures bilevel program under dp for darts, SAMA, CG, Neumann, reinforce
  (the JAX package's directions injected) and ITD within 1e-10; the small
  bert_data_reweighting program (the weighted loss divides by the global
  weight sum) within 1e-10; the small MWN ResNet (global BatchNorm
  statistics) within the MWN bound, 1e-8.
* Against each other: zero and fsdp equal dp bit for bit at two ranks
  (every leaf of the fixtures program sharded, and tutorial 5's program at
  the real threshold), and each rank holds only its shards; fsdp at four
  ranks within 1e-12 of dp (and on a 2 x 2 ``dcn`` x ``dp`` mesh); a
  two-rank fsdp run cut mid-unroll and
  auto-resumed equals the uninterrupted run bit for bit, and one in
  compiled blocks (the host-staging data path) equals driver mode.
* The other reductions over the batch (robust NAS's Jacobian, CURE and
  curvature terms, the IUC caption loss) and dropout under dp at 0.1 equal
  the one-process values on the global batch.
* The collectives against their definitions; ``fsdp_shardings`` and
  ``shard_loader`` against the JAX package's; the strategies and mesh axes
  that are not ported (pp, sp) raise.

``tests/torch_parallel_impl.py`` runs the JAX references (three processes)
and the ranks (two groups of two, one of four) side by side, each with a
timeout; one process group serves many cases.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from betty_tpu_torch import EngineConfig, parallel
from betty_tpu_torch.data import ArrayLoader, shard_loader
from betty_tpu_torch.parallel.mesh import Mesh, make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
IMPL = os.path.join(HERE, "torch_parallel_impl.py")
sys.path.insert(0, HERE)
from torch_parallel_impl import world_of_one  # noqa: E402
TIMEOUT = 300
SOLVERS = ("darts", "sama", "cg", "neumann", "reinforce", "itd")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    for k in ("BETTY_COORDINATOR_ADDRESS", "BETTY_NUM_PROCESSES", "BETTY_PROCESS_ID", "RANK",
              "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process at once: the three JAX references, the ranks of the
    "two" and "models" groups (torchrun's variables) and of the "four"
    group (the ``BETTY_*`` variables). Any failure or timeout fails."""
    work = tmp_path_factory.mktemp("parallel")
    procs = []
    for part in ("fixtures", "bert", "mwn"):
        procs.append((f"ref {part}", subprocess.Popen(
            [sys.executable, IMPL, "ref", str(work / f"ref_{part}.json"), part],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for group, world in (("two", 2), ("models", 2), ("four", 4)):
        port = _free_port()
        for rank in range(world):
            if group == "four":
                env = _env(BETTY_COORDINATOR_ADDRESS=f"localhost:{port}",
                           BETTY_NUM_PROCESSES=str(world), BETTY_PROCESS_ID=str(rank))
            else:
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
    for f in ("ref_fixtures", "ref_bert", "ref_mwn", "two", "models", "four"):
        with open(work / f"{f}.json") as fh:
            out[f] = json.load(fh)
    return out


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("solver", SOLVERS)
def test_two_rank_dp_matches_jax_global_batch(runs, solver):
    want = runs["ref_fixtures"][f"fixture:{solver}"]
    got = runs["two"][f"dp:{solver}"]
    errs = {n: _err(got[n], want[n]) for n in ("outer", "inner")}
    assert max(errs.values()) <= 1e-10, errs
    assert _err(got["outer"], np.ones(20)) > 1e-3  # the outer problem moved


@pytest.mark.parametrize("strategy", ["zero", "fsdp"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_zero_and_fsdp_equal_dp_bit_for_bit(runs, strategy, solver):
    case = runs["two"][f"{strategy}:{solver}"]
    assert case["ok"], case["info"]
    # every leaf of 20 elements sharded in two: fsdp the parameters and the
    # optimizer state, zero the optimizer state only
    for problem, shapes in case["info"]["shapes"].items():
        for leaf, shape in shapes.items():
            sharded = strategy == "fsdp" or leaf.startswith("opt_state")
            assert shape == ([10] if sharded else [20]), (problem, leaf, shape)


def test_fsdp_cut_and_auto_resumed_equals_uninterrupted(runs):
    case = runs["two"]["fsdp_resume"]
    assert case["ok"], case["info"]
    assert case["info"]["shapes"]["inner"]["params/w"] == [10]


def test_fsdp_compiled_blocks_equal_driver(runs):
    case = runs["two"]["fsdp_compiled"]
    assert case["ok"], case["info"]


def test_collectives_against_their_definitions(runs):
    case = runs["two"]["collectives"]
    assert case["ok"], case["info"]


@pytest.mark.parametrize("strategy", ["zero", "fsdp"])
def test_tutorial_program_zero_and_fsdp_equal_dp(runs, strategy):
    mlp = runs["models"]["mlp"]
    for name, params in mlp["dp"]["params"].items():
        for k, v in params.items():
            assert np.array_equal(np.asarray(mlp[strategy]["params"][name][k]), np.asarray(v)), \
                (name, k)
    shapes = mlp[strategy]["shapes"]["classifier"]
    # the 784 x 128 kernel (100,352 elements) is sharded on its 784 axis;
    # everything under 2**14 elements stays whole
    assert shapes["opt_state/trace/layers.0.weight"] == [128, 392]
    assert shapes["params/layers.0.weight"] == ([128, 392] if strategy == "fsdp" else [128, 784])
    assert shapes["params/layers.1.weight"] == [2, 128]
    assert all(s == shapes[k] for k, s in mlp["dp"]["shapes"]["classifier"].items()
               if "layers.0.weight" not in k)


def test_bert_weighted_loss_normaliser_matches_jax_global_batch(runs):
    want, got = runs["ref_bert"]["bert"], runs["models"]["bert"]
    errs = {f"{n}/{k}": _err(got[n][k], v) for n in want for k, v in want[n].items()}
    assert set(got["classifier"]) == set(want["classifier"])
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_examples_batch_coupled_terms_are_the_global_batchs(runs):
    case = runs["models"]["batch_coupled"]
    assert case["ok"], case["info"]


def test_dropout_draws_the_global_batchs_masks(runs):
    case = runs["models"]["bert_dropout"]
    assert case["ok"], case["info"]


def test_mwn_global_batchnorm_matches_jax_global_batch(runs):
    want, got = runs["ref_mwn"]["mwn"], runs["models"]["mwn"]
    errs = {f"{n}/{k}": _err(got[n][k], v) for n in want for k, v in want[n].items()}
    assert set(got["batch_stats"]) == set(want["batch_stats"])
    assert max(errs.values()) <= 1e-8, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("solver", ["darts", "sama"])
def test_four_rank_fsdp_matches_dp(runs, solver):
    case = runs["four"][f"fsdp4:{solver}"]
    assert case["ok"], case["info"]


@pytest.mark.parametrize("solver", ["darts", "sama"])
def test_dcn_by_dp_mesh_fsdp_matches_dp(runs, solver):
    case = runs["four"][f"dcn:{solver}"]
    assert case["ok"], case["info"]
    assert case["info"]["shapes"]["inner"]["params/w"] == [10]  # sharded over dp only


def test_four_rank_tutorial_program_fsdp_matches_dp(runs):
    mlp = runs["four"]["mlp"]
    errs = [_err(mlp["fsdp"]["params"][n][k], v) for n, p in mlp["dp"]["params"].items()
            for k, v in p.items()]
    assert max(errs) <= 1e-12, max(errs)
    assert mlp["fsdp"]["shapes"]["classifier"]["params/layers.0.weight"] == [128, 196]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

TREES = [
    {"w": np.zeros((784, 128)), "b": np.zeros(128), "k": np.zeros((3, 3, 64, 64)),
     "e": np.zeros((50265, 16)), "s": np.zeros(())},
    {"odd": np.zeros((127, 129)), "wide": np.zeros((8, 4096)), "small": np.zeros((64, 64))},
]


@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_shardings_match_jax(size):
    import jax
    from jax.sharding import Mesh as JMesh

    from betty_tpu.parallel import fsdp_shardings as jax_fsdp_shardings

    jmesh = JMesh(np.asarray(jax.devices()[:size]), ("dp",))
    mesh = Mesh(axes=(("dp", size),), rank=0, world=size)
    for tree in TREES:
        theirs = jax_fsdp_shardings({k: jax.ShapeDtypeStruct(v.shape, np.float32)
                                     for k, v in tree.items()}, jmesh)
        ours = parallel.fsdp_shardings({k: torch.zeros(v.shape) for k, v in tree.items()}, mesh)
        for k in tree:
            spec = tuple(theirs[k].spec)
            want = spec.index("dp") if "dp" in spec else None
            assert ours[k] == want, (size, k, ours[k], spec)


@pytest.mark.parametrize("count", [2, 3])
def test_shard_loader_matches_jax(count):
    from betty_tpu.data import ArrayLoader as JArrayLoader
    from betty_tpu.data import shard_loader as jax_shard_loader

    class Scaled(ArrayLoader):
        def postprocess(self, batch):
            x, y = batch
            return 2 * x, y

    x = np.arange(50 * 3).reshape(50, 3).astype(np.int32)
    y = np.arange(50).astype(np.int32)
    for i in range(count):
        ours = shard_loader(Scaled(x, y, batch_size=4, seed=3), i, count)
        theirs = jax_shard_loader(JArrayLoader(x, y, batch_size=4, seed=3), i, count)
        assert isinstance(ours, Scaled) and ours.n == theirs.n
        ours.set_epoch(2)
        theirs.set_epoch(2)
        for (gx, gy), (wx, wy) in zip(ours, theirs):
            assert np.array_equal(np.asarray(gx), 2 * np.asarray(wx))
            assert np.array_equal(np.asarray(gy), np.asarray(wy))


def test_model_parallel_strategies_and_axes_raise():
    # tp, ep, pp and sp (the mdl, ep, pp and sp axes) are ported, and meshes
    # with two to four different model axes are accepted (a one-process
    # make_mesh of one says it does not cover the world; the ranks of
    # tests/test_torch_three_axes*.py build them); a repeated axis raises
    for s in ("tp", "ep", "pp", "sp"):
        assert EngineConfig(strategy=s).strategy == s
    for axis in ("pp", "sp"):
        assert EngineConfig(strategy=axis, mesh_shape=(("dp", 1), (axis, 2))).strategy == axis
        two = (("dp", 1), ("mdl", 2), (axis, 2))
        assert EngineConfig(strategy="tp", mesh_shape=two).mesh_shape == two
        assert EngineConfig(strategy="fsdp", mesh_shape=two + (("ep", 2),)).strategy == "fsdp"
        parallel.mesh.check_axes((("dp", 1), ("ep", 2), (axis, 2), ("mdl", 2)))
        with world_of_one():
            with pytest.raises(ValueError, match="does not cover"):
                make_mesh((("dp", 1), ("ep", 2), (axis, 2), ("mdl", 2)))
        with pytest.raises(ValueError, match="different model axes"):
            make_mesh((("dp", 1), (axis, 2), (axis, 2)))
    with pytest.raises(ValueError, match="strategy"):
        EngineConfig(strategy="ddp")
    # pp on a mesh without its axis names the axis; sp's parameters stay whole
    with pytest.raises(ValueError, match="'pp'"):
        parallel.state_shard_dims({"params": {}}, Mesh((("dp", 1),), 0, 1), "pp")
    assert parallel.state_shard_dims({"params": {}}, Mesh((("dp", 1), ("sp", 1)), 0, 1),
                                     "sp") == {}


def test_helpers_are_the_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.current() is None
    assert parallel.global_sum(x) is x and parallel.global_mean(x) is x
    assert parallel.grad_mean({"a": x})["a"] is x
    gen = torch.Generator().manual_seed(0)
    rows = parallel.local_rows((4, 3), lambda s: torch.rand(s, generator=gen))
    assert torch.equal(rows, torch.rand((4, 3), generator=torch.Generator().manual_seed(0)))


def test_local_rows_take_this_ranks_rows_of_the_global_draw():
    mesh = Mesh((("dp", 4),), rank=2, world=4)
    draw = lambda s: torch.arange(float(np.prod(s))).reshape(s)  # noqa: E731
    with parallel.active(mesh):
        assert torch.equal(parallel.local_rows((2, 3), draw), draw((8, 3))[2::4])
        assert torch.equal(parallel.local_rows((4, 2), draw, dim=1), draw((4, 8))[:, 2::4])
