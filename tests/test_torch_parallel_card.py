"""The data-parallel strategies on the card: a world of one over NCCL, the
collectives made over one rank, equal to the one-process run bit for bit;
and, on a machine with several cards, one rank a card over NCCL. Imports
no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_parallel_card.py

Skips without a CUDA device (the several-card case: with fewer than two);
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
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANKS, str(world)], cwd=ROOT,
        env=_env(BETTY_COORDINATOR_ADDRESS=f"localhost:{port}",
                 BETTY_NUM_PROCESSES=str(world), BETTY_PROCESS_ID=str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    line = [ln for ln in outs[0].splitlines() if ln.startswith("REPORT ")][-1]
    print(line)
    report = json.loads(line[len("REPORT "):])
    assert report["bert_replicas_equal"] and report["t5_moved"] > 0, report
    assert max(report["t5_err"].values()) <= 1e-10, report
    assert max(report["zero_fsdp_vs_dp"].values()) <= 1e-12, report
