"""The strategies on the card: a world of one over NCCL, the collectives
made over one rank, equal to the one-process run bit for bit; on a machine
with several cards, one rank a card over NCCL; on four cards, tensor
parallelism (tutorial 7's tp mode on ``dp:2,mdl:2``), expert parallelism
(the MoE program on ``ep:4``), pipeline and sequence parallelism
(tutorial 7's pp and sp modes on ``dp:2,pp:2`` and ``dp:2,sp:2``) and the
composed mesh (its pp mode on ``dp:1,mdl:2,pp:2``) in float64 against one
process on the global batch. Imports no JAX, so it
runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_parallel_card.py

Skips without a CUDA device (the several-card cases: with fewer than two,
or four, cards);
``chip_smoke.py``'s dist phase runs the north star the same way. Each case
runs in subprocesses of its own (a process joins one process group)."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, sys
import torch
from betty_tpu_torch import parallel

strategy, compiled = sys.argv[1], sys.argv[2] == "1"
t5 = importlib.import_module("betty_tpu_torch.tutorial.5_distributed_training")


def run(strategy, compiled):
    argv = ["--device", "cuda", "--strategy", strategy, "--train_iters", "24",
            "--batch_size", "32"]
    engine = t5.build_engine(t5.parse_args(argv))
    engine.config.compile_blocks = compiled
    engine.run()
    return {p.name: p.full_state()["params"] for p in engine.problems}, engine


parallel.maybe_init_distributed("cuda")
assert torch.distributed.get_backend() == "nccl"
want, _ = run("default", False)
got, engine = run(strategy, compiled)
if compiled:
    assert engine.block_runner.captures == 1 and engine.block_runner.replays > 0
same = all(torch.equal(got[n][k], v) for n, p in want.items() for k, v in p.items())
print("OK" if same else "DIFFERENT")
"""


RANKS = r"""
import importlib, json, sys
import numpy as np
import torch
from betty_tpu_torch import parallel
from betty_tpu_torch.utils import tree_leaves, tree_map

world = int(sys.argv[1])
bert = importlib.import_module("betty_tpu_torch.examples.bert_data_reweighting")
t5 = importlib.import_module("betty_tpu_torch.tutorial.5_distributed_training")
report = {}

# the bert example joins the group itself, before it builds anything: each
# rank's modules, data and state on its own card, none on card 0
engine = bert.build_engine(bert.parse_args([
    "--dim", "64", "--depth", "2", "--heads", "2", "--seq_len", "32", "--train_size", "512",
    "--meta_size", "128", "--batch_size", "16", "--unroll_steps", "2", "--train_iters", "8",
    "--strategy", "fsdp", "--device", "cuda", "--device_data"]))
engine.run()
rank = torch.distributed.get_rank()
assert torch.distributed.get_backend() == "nccl" and torch.distributed.get_world_size() == world
assert engine.device == torch.device("cuda", rank), engine.device
held = [x for st in engine.states.values() for x in tree_leaves(st) if torch.is_tensor(x)]
assert all(x.device == engine.device for x in held if x.is_cuda)
if rank > 0:
    assert torch.cuda.memory_allocated(0) == 0, torch.cuda.memory_allocated(0)
whole = torch.cat([v.reshape(-1).float() for p in engine.problems
                   for v in p.full_state()["params"].values()])
assert bool(torch.isfinite(whole).all())
spread = whole.clone()
torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX)
report["bert_replicas_equal"] = bool(torch.equal(spread, whole))
del engine


def t5_run(strategy, batch):
    # tutorial 5's program in float64, unshuffled: the ranks' batches are
    # the one-process run's global batch. Returns (start, end) parameters.
    engine = t5.build_engine(t5.parse_args(["--device", "cuda", "--train_iters", "12",
                                            "--no_shuffle", "--strategy", strategy,
                                            "--batch_size", str(batch)]))
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                             and t.is_floating_point() else t, engine.states)
    for p in engine.problems:
        for dl in p.train_data_loader:
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])

    def params():
        return {f"{p.name}.{k}": v.detach().cpu().clone() for p in engine.problems
                for k, v in p.full_state()["params"].items()}

    start = params()
    engine.run()
    return start, params()


got = {s: t5_run(s, 32)[1] for s in ("dp", "zero", "fsdp")}
if rank == 0:
    start, want = t5_run("default", 32 * world)
    report["t5_err"] = {s: max(float((g[k] - want[k]).abs().max()) for k in want)
                        for s, g in got.items()}
    report["t5_moved"] = max(float((want[k] - v).abs().max()) for k, v in start.items())
    report["zero_fsdp_vs_dp"] = {s: max(float((got[s][k] - got["dp"][k]).abs().max())
                                        for k in want) for s in ("zero", "fsdp")}
    print("REPORT " + json.dumps(report), flush=True)
torch.distributed.barrier()
"""


MP_RANKS = r"""
import importlib, json, sys
import torch
from betty_tpu_torch import parallel
from betty_tpu_torch.utils import tree_leaves, tree_map

t7 = importlib.import_module("betty_tpu_torch.tutorial.7_model_parallelism")
moe = importlib.import_module("betty_tpu_torch.examples.moe_reweighting")
MOE = ["--dim", "16", "--hidden", "32", "--experts", "4", "--tokens", "64", "--val_tokens",
       "32", "--dense", "--train_iters", "4", "--device", "cuda"]
parallel.maybe_init_distributed("cuda")
rank = torch.distributed.get_rank()


def f64(engine, batches=False):
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                             and t.is_floating_point() else t, engine.states)
    if batches:
        for p in engine.problems:
            (x, y), = p.train_data_loader[0]
            p.train_data_loader[0][0] = (x.double(), y)
    return engine


def run(engine):
    start = [x.detach().cpu().clone() for p in engine.problems
             for x in tree_leaves(p.full_state()["params"])]
    engine.run()
    end = [x.detach().cpu().clone() for p in engine.problems
           for x in tree_leaves(p.full_state()["params"])]
    return start, end, engine


def err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


report = {}
_, tp, engine = run(f64(t7.build_engine(t7.parse_args(
    ["--device", "cuda", "--train_iters", "6", "--mesh", "dp:2,mdl:2"]))))
report["t7_query_kernel"] = list(engine.states["classifier"]["params"]
                                 ["blocks.0.attn.query.kernel"].shape)
_, ep, engine = run(f64(moe.build_engine(moe.parse_args(
    MOE + ["--strategy", "ep", "--mesh", "ep:4"])), batches=True))
report["moe_w1"] = list(engine.states["inner"]["params"]["moe"]["w1"].shape)
if rank == 0:
    start, want, _ = run(f64(t7.build_engine(t7.parse_args(
        ["--device", "cuda", "--train_iters", "6", "--mesh", "none"]))))
    report["t7_err"], report["t7_moved"] = err(tp, want), err(want, start)
    start, want, _ = run(f64(moe.build_engine(moe.parse_args(MOE)), batches=True))
    report["moe_err"], report["moe_moved"] = err(ep, want), err(want, start)
    print("REPORT " + json.dumps(report), flush=True)
torch.distributed.barrier()
"""


T7_RANKS = r"""
import importlib, json, sys
import torch
from betty_tpu_torch import parallel
from betty_tpu_torch.utils import tree_leaves, tree_map

t7 = importlib.import_module("betty_tpu_torch.tutorial.7_model_parallelism")
parallel.maybe_init_distributed("cuda")
rank = torch.distributed.get_rank()


def run(mode, mesh):
    engine = t7.build_engine(t7.parse_args(["--device", "cuda", "--train_iters", "6", "--mode",
                                            mode, "--mesh", mesh]))
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                             and t.is_floating_point() else t, engine.states)
    start = [x.detach().cpu().clone() for p in engine.problems
             for x in tree_leaves(p.full_state()["params"])]
    engine.run()
    end = [x.detach().cpu().clone() for p in engine.problems
           for x in tree_leaves(p.full_state()["params"])]
    return start, end, engine


def err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))
"""

PP_RANKS = T7_RANKS + r"""

report = {}
_, pp, engine = run("pp", "dp:2,pp:2")
report["pp_query_kernel"] = list(engine.states["classifier"]["params"]
                                 ["blocks.attn.query.kernel"].shape)
_, sp, _ = run("sp", "dp:2,sp:2")
if rank == 0:
    start, want, _ = run("pp", "none")  # the one-process run of both modes
    report["pp_err"], report["sp_err"] = err(pp, want), err(sp, want)
    report["moved"] = err(want, start)
    print("REPORT " + json.dumps(report), flush=True)
torch.distributed.barrier()
"""

# the composed mesh: tutorial 7's pp mode on dp:1,mdl:2,pp:2 (2 of the 4
# stacked blocks and 2 of the 4 heads a rank, M 4)
COMPOSED_RANKS = T7_RANKS + r"""

report = {}
_, got, engine = run("pp", "dp:1,mdl:2,pp:2")
params = engine.states["classifier"]["params"]
report["query_kernel"] = list(params["blocks.attn.query.kernel"].shape)
report["fc2_weight"] = list(params["blocks.fc2.weight"].shape)
if rank == 0:
    start, want, _ = run("pp", "none")
    report["err"], report["moved"] = err(got, want), err(want, start)
    print("REPORT " + json.dumps(report), flush=True)
torch.distributed.barrier()
"""


def _launch_ranks(script, world, timeout=400):
    """``world`` ranks of ``script`` (``BETTY_*`` variables, one a card):
    rank 0's REPORT line, parsed."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(world)], cwd=ROOT,
        env=_env(BETTY_COORDINATOR_ADDRESS=f"localhost:{port}",
                 BETTY_NUM_PROCESSES=str(world), BETTY_PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    line = [ln for ln in outs[0].splitlines() if ln.startswith("REPORT ")][-1]
    print(line)
    return json.loads(line[len("REPORT "):])


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                        "BETTY_COORDINATOR_ADDRESS", "BETTY_NUM_PROCESSES", "BETTY_PROCESS_ID")}
    env.update(extra)
    return env


def _run(strategy, compiled=False):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's dist phase runs the north star")
    out = subprocess.run([sys.executable, "-c", SCRIPT, strategy, "1" if compiled else "0"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK", out.stdout[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["dp", "zero", "fsdp"])
def test_world_of_one_over_nccl_equals_default(strategy):
    _run(strategy)


@pytest.mark.gpu
def test_compiled_fsdp_replays_its_collectives():
    _run("fsdp", compiled=True)


@pytest.mark.gpu
def test_one_rank_a_card_over_nccl():
    """Every card a rank (``BETTY_*`` variables), NCCL: the bert example
    under fsdp builds each rank's modules on its own card (nothing lands
    on card 0) and its replicas agree; tutorial 5's program in float64
    under dp, zero and fsdp reaches the one-process run on the global batch
    within 1e-10."""
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2:
        pytest.skip("needs two or more CUDA cards")
    report = _launch_ranks(RANKS, world)
    assert report["bert_replicas_equal"] and report["t5_moved"] > 0, report
    assert max(report["t5_err"].values()) <= 1e-10, report
    assert max(report["zero_fsdp_vs_dp"].values()) <= 1e-12, report


@pytest.mark.gpu
def test_tp_and_ep_on_four_cards_over_nccl():
    """Four ranks, one a card, NCCL: tutorial 7's tp mode on ``dp:2,mdl:2``
    (half the heads and MLP columns a rank) and the MoE program on ``ep:4``
    (one expert a rank), float64, within 1e-10 of one process on the global
    batch."""
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 4:
        pytest.skip("needs four CUDA cards")
    report = _launch_ranks(MP_RANKS, 4)
    assert report["t7_query_kernel"] == [64, 2, 16] and report["moe_w1"] == [1, 16, 32], report
    assert report["t7_moved"] > 0 and report["moe_moved"] > 0, report
    assert report["t7_err"] <= 1e-10 and report["moe_err"] <= 1e-10, report


@pytest.mark.gpu
def test_pp_and_sp_on_four_cards_over_nccl():
    """Four ranks, one a card, NCCL: tutorial 7's pp mode on ``dp:2,pp:2``
    (2 of the 4 stacked blocks a rank, M 4) and its sp mode on ``dp:2,sp:2``
    (8 of the 16 positions a rank), float64, within 1e-10 of one process on
    the global batch."""
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 4:
        pytest.skip("needs four CUDA cards")
    report = _launch_ranks(PP_RANKS, 4)
    assert report["pp_query_kernel"] == [2, 64, 4, 16] and report["moved"] > 0, report
    assert report["pp_err"] <= 1e-10 and report["sp_err"] <= 1e-10, report


@pytest.mark.gpu
def test_composed_mdl_pp_on_four_cards_over_nccl():
    """Four ranks, one a card, NCCL: tutorial 7's pp mode on the composed
    mesh ``dp:1,mdl:2,pp:2`` (Megatron tensor parallelism over ``mdl``
    inside each GPipe stage; 2 of the 4 stacked blocks and 2 of the 4 heads
    a rank), float64, within 1e-10 of one process on the global batch."""
    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 4:
        pytest.skip("needs four CUDA cards")
    report = _launch_ranks(COMPOSED_RANKS, 4)
    assert report["query_kernel"] == [2, 64, 2, 16] and report["fc2_weight"] == [2, 64, 128]
    assert report["moved"] > 0 and report["err"] <= 1e-10, report
