"""The composed ``dp x mdl x pp`` mesh of the port on the CPU over gloo, in
float64, against the JAX package's sequential runs and the port's own
one-process runs. Run by test_torch_composed.py.

The JAX references are ``torch_pp_impl.py``'s (``make_pipelined_transformer``
sequential at tests/test_composed.py's CFG, the bilevel program of
tests/test_composed.py:230-262 under darts and CG in both HVP modes; the
data of tests/test_pp.py, whose last two positions are padding).

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_composed_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port. GROUP ``mdl2pp2`` (``dp:1,mdl:2,pp:2``, 4
        ranks, M 2) or ``dp2mdl2pp2`` (``dp:2,mdl:2,pp:2``, 8 ranks, M 2),
        under ``strategy="tp"`` with ``models.COMPOSED_SHARD_RULES``: the
        forward and every gradient, ``sharded_norm`` of the gradients, the
        darts program, each against the port's one-process run too;
        ``mdl2pp2`` adds CG (``"jvp"``, ``"vjp"``, and ``"jvp"`` through
        the fused vector loop), darts under ``strategy="pp"`` (the blocks
        whole over ``mdl``), the shards and Adam moments held, compiled
        blocks against driver mode and a run cut and auto-resumed. Rank 0
        writes the results.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch_parallel_impl as tpi  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402

GROUPS = {"mdl2pp2": ("dp:1,mdl:2,pp:2", 2), "dp2mdl2pp2": ("dp:2,mdl:2,pp:2", 2)}
WORLDS = {"mdl2pp2": 4, "dp2mdl2pp2": 8}
# program -> (strategy, solver of torch_pp_impl.SOLVERS, fused vector loop)
PROGRAMS = {"tp:darts": ("tp", "darts", False), "tp:cg_jvp": ("tp", "cg_jvp", False),
            "tp:cg_vjp": ("tp", "cg_vjp", False), "tp:cg_fused": ("tp", "cg_jvp", True),
            "pp:darts": ("pp", "darts", False)}
GROUP_PROGRAMS = {"mdl2pp2": tuple(PROGRAMS), "dp2mdl2pp2": ("tp:darts",)}


def _rules():
    from betty_tpu_torch.models import COMPOSED_SHARD_RULES

    return COMPOSED_SHARD_RULES


def engine(program, mesh_spec, init, M=None, **kw):
    """``torch_pp_impl.port_engine``'s program under ``program``; ``mesh_spec``
    None: the one-process run."""
    strategy, solver, fused = PROGRAMS[program]
    eng = ppi.port_engine(solver, strategy if mesh_spec else "default", mesh_spec, init, M,
                          rules=_rules(), **kw)
    eng.classifier.config.use_fused_vector_ops = fused
    return eng


def case_forward(mesh_spec, M, init, res):
    """The forward logits and every leaf's gradient (the mean cross entropy
    of the global batch) on the composed layout, the ring shifts of a
    forward, the shards held, and ``sharded_norm`` of the gradient shards
    against the norm of the whole gradients."""
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import parallel
    from betty_tpu_torch.parallel import collectives

    mesh = parallel.make_mesh(parallel.mesh_shape(mesh_spec))
    module = ppi.pipelined_module(mesh_spec, M)
    ids, y = ppi.data(64, 0)
    rows = slice(mesh.batch_index, None, mesh.batch_world)
    ids, y = torch.tensor(ids[rows]), torch.tensor(y[rows]).long()
    params = dict(init["classifier"])
    dims = parallel.state_shard_dims({"params": params}, mesh, "tp", rules=_rules())["params"]
    params = parallel.mesh.shard_tree(params, dims, mesh, "model")
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with parallel.active(mesh):
        collectives.CALLS.clear()
        with torch.no_grad():
            module.apply({"params": params}, ids, train=False)
        calls = dict(collectives.CALLS)
        logits = module.apply({"params": params}, ids, train=False)
        loss = F.cross_entropy(logits, y)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    grads = parallel.grad_mean(grads, mesh)
    norm = float(parallel.sharded_norm(grads, dims, mesh))
    grads = parallel.gather_shards(grads, dims, mesh, "model")
    whole_norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    all_logits = parallel.mesh.make_global_batch(logits.detach(), mesh)
    order = torch.empty_like(all_logits)
    w = mesh.batch_world
    for b in range(w):
        order[b::w] = all_logits[b * (64 // w):(b + 1) * (64 // w)]
    res["forward"] = {
        "ok": True, "logits": order.tolist(), "grads": tpi._lists(grads),
        "info": {"calls": calls, "held": {k: list(v.shape) for k, v in params.items()},
                 "dims": {k: repr(d) for k, d in dims.items()},
                 "norm": norm, "whole_norm": whole_norm}}


def case_programs(mesh_spec, M, init, res, rank, programs):
    """The programs on the composed mesh against the port's one-process run
    (rank 0 runs it) and, in the test, JAX's."""
    for program in programs:
        want = None
        if rank == 0:
            ref = engine(program, None, init)
            ref.run()
            want = ppi.whole_params(ref)
        eng = engine(program, mesh_spec, init, M)
        eng.run()
        got = ppi.whole_params(eng)
        if rank == 0:
            err = tpi.max_err(got, want)
            res[program] = {"ok": err <= 1e-12, "info": {"max_abs_err": err},
                            "params": {n: tpi._lists(t) for n, t in got.items()}}


def case_details(mesh_spec, M, init, work_dir, res):
    """Compiled blocks against driver mode, and a run cut mid-unroll and
    auto-resumed (Adam on the blocks) against the uninterrupted one, with
    the shards of the parameters and the moments held."""
    import torch

    from betty_tpu_torch import optim

    runs, runner = {}, None
    for compiled in (False, True):
        eng = engine("tp:darts", mesh_spec, init, M, iters=8, compile_blocks=compiled)
        eng.run()
        runs[compiled] = ppi.whole_params(eng)
        runner = eng.block_runner
    res["compiled"] = {"ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
                       and runner.periods_run > 0,
                       "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                                "periods": getattr(runner, "periods_run", 0)}}

    cut = os.path.join(work_dir, "composed_checkpoint")

    def run(**kw):
        return engine("tp:darts", mesh_spec, init, M, iters=4, optimizer=optim.adam(lr=1e-3),
                      **kw)

    straight = run()
    straight.run()
    first = run(checkpoint_step=3, checkpoint_dir=cut)
    first.train_iters = 3
    first.run()
    resumed = run(checkpoint_dir=cut, auto_resume=True)
    resumed.run()
    a, b = ppi.whole_params(straight), ppi.whole_params(resumed)
    saved = torch.load(os.path.join(cut, "step_3.pt"), weights_only=True)
    state = straight.states["classifier"]
    res["resume"] = {
        "ok": tpi.bit_equal(a, b) and resumed.global_step == 4,
        "info": {"max_abs_err": tpi.max_err(a, b), "global_step": resumed.global_step,
                 "saved": {k: list(saved["classifier"]["params"][k].shape)
                           for k in ("blocks.attn.query.kernel", "blocks.fc2.weight")},
                 "held": {k: list(v.shape) for k, v in state["params"].items()},
                 "moments": {k: [list(state["opt_state"][m][k].shape) for m in ("mu", "nu")]
                             for k in state["params"]}}}


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    init = tpi.take_over(os.path.join(work_dir, "init.pt"))
    mesh, M = GROUPS[group]
    res = {}
    t0 = time.time()
    case_forward(mesh, M, init, res)
    case_programs(mesh, M, init, res, rank, GROUP_PROGRAMS[group])
    if group == "mdl2pp2":
        case_details(mesh, M, init, work_dir, res)
    res["seconds"] = round(time.time() - t0, 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


def launch(work):
    """The three JAX references and both groups side by side."""
    return ppi.launch(work, tuple(GROUPS), script=os.path.abspath(__file__), worlds=WORLDS)


if __name__ == "__main__":
    run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
