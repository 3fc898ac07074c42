"""State donation under the port's strategies, on the CPU over gloo: one
rank of two. Run by test_torch_donate.py.

    RANK=i WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_donate_impl.py OUT.json

Each case builds the small bert program (SAMA, Adam, fp32) twice, without
and with ``--donate``, runs both and compares every problem's whole state
bit for bit; the donated run's leaves (this rank's shards) must keep their
storage through the run. Cases: ``zero`` and ``fsdp`` with every leaf
sharded (``FSDP_MIN_SIZE`` 1: zero's optimizer steps this rank's shard of
each parameter, fsdp's the shards the state holds), ``fsdp`` in compiled
blocks, and ``tp`` on ``dp:1,mdl:2``. Rank 0 writes the results.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

BERT_ARGV = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len", "8", "--batch_size", "4",
             "--train_size", "64", "--meta_size", "32", "--precision", "fp32", "--dropout", "0",
             "--unroll_steps", "2", "--train_iters", "8", "--hypergradient", "sama", "--flash",
             "--device", "cpu"]
CASES = {  # name: (argv, compiled)
    "zero": (["--strategy", "zero"], False),
    "fsdp": (["--strategy", "fsdp"], False),
    "fsdp_compiled": (["--strategy", "fsdp"], True),
    "tp": (["--strategy", "tp", "--mesh", "dp:1,mdl:2"], False),
}


def storages(engine):
    """The storage of every tensor leaf of the states this rank holds."""
    import torch

    from betty_tpu_torch.utils import tree_paths

    return {(name, path): x.data_ptr() for name, s in engine.states.items()
            for path, x in tree_paths({k: s[k] for k in ("params", "opt_state", "grad_acc",
                                                          "last_grad", "extra") if k in s})
            if isinstance(x, torch.Tensor)}


def run_case(argv, compiled, donate):
    from betty_tpu_torch.examples import bert_data_reweighting as tex
    from betty_tpu_torch.utils import tree_paths

    engine = tex.build_engine(tex.parse_args(BERT_ARGV + argv + (["--donate"] if donate else [])
                                             + (["--compile_blocks"] if compiled else [])))
    engine.config.block_periods = 1
    before, moved = storages(engine), []
    check = engine.maybe_validate_checkpoint

    def hook(window=1):
        now = storages(engine)
        moved.extend(k for k in before if now.get(k) != before[k])
        return check(window)

    engine.maybe_validate_checkpoint = hook
    engine.run()
    whole = {p.name: dict(tree_paths(p.full_state())) for p in engine.problems}
    info = {"donate": [p.donate for p in engine.problems], "moved": len(set(moved)),
            "leaves": len(before)}
    if compiled:
        info["runner_donate"] = engine.block_runner.donate
        info["periods"] = engine.block_runner.periods_run
    return whole, info


def main(out):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel
    from betty_tpu_torch.parallel import mesh as mesh_mod

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    mesh_mod.FSDP_MIN_SIZE = 1
    res = {}
    t0 = time.time()
    for name, (argv, compiled) in CASES.items():
        plain, plain_info = run_case(argv, compiled, False)
        donated, info = run_case(argv, compiled, True)
        equal = all(plain[n].keys() == donated[n].keys() and all(
            torch.equal(x, donated[n][k]) if torch.is_tensor(x) else x == donated[n][k]
            for k, x in plain[n].items()) for n in plain)
        ok = (equal and all(info["donate"]) and info["moved"] == 0 and plain_info["moved"] > 0
              and not any(plain_info["donate"])
              and (not compiled or (info["runner_donate"] and info["periods"] > 0)))
        res[name] = {"ok": bool(ok), "equal": bool(equal), "donated": info,
                     "undonated": plain_info, "seconds": round(time.time() - t0, 2)}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
