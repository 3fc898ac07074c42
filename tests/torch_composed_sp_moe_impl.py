"""Sequence parallelism and the Switch MoE beside a second model axis, on
the CPU over gloo, in float64, against the JAX package's unsharded runs and
the port's own one-process runs. Run by test_torch_composed_sp_moe.py.

The JAX references: ``torch_pp_impl.py``'s (``make_pipelined_transformer``
sequential at tests/test_composed.py's CFG, the bilevel program under darts
and CG in both HVP modes, the data of tests/test_pp.py) and
``torch_tp_impl.py``'s ``ref_moe`` (tests/test_ep.py's MoE program,
unsharded).

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_composed_sp_moe_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port; rank 0 writes the results. GROUP:

        ``mdl2sp2`` (``dp:1,mdl:2,sp:2``, 4 ranks): Megatron-SP under
        ``strategy="tp"`` with ``models.SP_COMPOSED_SHARD_RULES``: the
        forward and every gradient, ``sharded_norm``, darts, CG (``"jvp"``,
        ``"vjp"``, and ``"jvp"`` through the fused vector loop), darts
        under ``strategy="sp"`` (every leaf whole), compiled blocks against
        driver mode, and a run cut and auto-resumed with the shards and
        Adam moments held.
        ``dp2mdl2sp2`` (``dp:2,mdl:2,sp:2``, 8 ranks): the forward and
        darts.
        ``ep2mdl2`` (``dp:1,ep:2,mdl:2``, 4 ranks): the MoE program under
        ``strategy="tp"`` with ``models.MOE_COMPOSED_SHARD_RULES`` and under
        ``strategy="ep"``, compiled blocks against driver mode, and the
        layer at capacities 2, the default and T against one process (the
        kept and dropped tokens alike).
        ``pp2sp2`` (``dp:1,pp:2,sp:2``, 4 ranks): the encoder built with
        ``seq_axis="sp"`` beside ``pp`` (pipelining wins, the ``sp`` ranks
        repeat) under ``strategy="pp"``, then on ``dp:1,ep:2,sp:2`` under
        ``strategy="sp"`` (the ``ep`` ranks repeat); darts.
        ``ep2pp2`` (``dp:1,ep:2,pp:2``, 4 ranks): the MoE program under
        ``strategy="ep"`` (the ``pp`` ranks repeat), then on
        ``dp:1,ep:2,sp:2``.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch_parallel_impl as tpi  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402
from torch_tp_impl import moe_engine  # noqa: E402

GROUPS = {"mdl2sp2": "dp:1,mdl:2,sp:2", "dp2mdl2sp2": "dp:2,mdl:2,sp:2",
          "ep2mdl2": "dp:1,ep:2,mdl:2", "pp2sp2": "dp:1,pp:2,sp:2", "ep2pp2": "dp:1,ep:2,pp:2"}
WORLDS = {"mdl2sp2": 4, "dp2mdl2sp2": 8, "ep2mdl2": 4, "pp2sp2": 4, "ep2pp2": 4}
EP_SP = "dp:1,ep:2,sp:2"
# program -> (strategy, solver of torch_pp_impl.SOLVERS, fused vector loop)
PROGRAMS = {"tp:darts": ("tp", "darts", False), "tp:cg_jvp": ("tp", "cg_jvp", False),
            "tp:cg_vjp": ("tp", "cg_vjp", False), "tp:cg_fused": ("tp", "cg_jvp", True),
            "sp:darts": ("sp", "darts", False)}
GROUP_PROGRAMS = {"mdl2sp2": tuple(PROGRAMS), "dp2mdl2sp2": ("tp:darts",)}
MOE_DIM, MOE_HIDDEN, MOE_EXPERTS, MOE_TOKENS = 16, 32, 4, 64


def _sp_rules():
    from betty_tpu_torch.models import SP_COMPOSED_SHARD_RULES

    return SP_COMPOSED_SHARD_RULES


def engine(program, mesh_spec, init, **kw):
    """``torch_pp_impl.port_engine``'s program built with ``seq_axis="sp"``
    under ``program``; ``mesh_spec`` None: the one-process run."""
    strategy, solver, fused = PROGRAMS[program]
    eng = ppi.port_engine(solver, strategy if mesh_spec else "default", mesh_spec, init,
                          sp=True, rules=_sp_rules(), **kw)
    eng.classifier.config.use_fused_vector_ops = fused
    return eng


def _rank0_reference(rank, build):
    """The one-process run's whole parameters on rank 0 (None elsewhere)."""
    if rank != 0:
        return None
    ref = build()
    ref.run()
    return ppi.whole_params(ref)


def run_counting_gathers(eng):
    """``eng.run()``, counting the all-gathers by the mesh's group they go
    over (``mdl``, ``sp``, ``ep``, ``pp``, ``model``, ``batch``): under a
    layout the module computes on, the parameters are never gathered over a
    model axis, so only ``sp``'s keys and values are."""
    import torch.distributed as dist

    counts, orig = {}, dist.all_gather_into_tensor

    def wrapped(*a, **kw):
        key = id(kw.get("group"))
        counts[key] = counts.get(key, 0) + 1
        return orig(*a, **kw)

    dist.all_gather_into_tensor = wrapped
    try:
        eng.run()
    finally:
        dist.all_gather_into_tensor = orig
    mesh = eng.mesh
    labels = {id(g): a for a, g in mesh.axis_groups.items()}
    labels[id(mesh.batch_group)] = "batch"
    return {labels.get(k, "other"): n for k, n in counts.items()}


def _compare(res, key, rank, got, want, **info):
    if rank == 0:
        err = tpi.max_err(got, want)
        res[key] = {"ok": err <= 1e-12, "info": {"max_abs_err": err, **info},
                    "params": {n: {k: v.tolist() for k, v in tpi.leaves(t).items()}
                               for n, t in got.items()}}


# ---------------------------------------------------------------------------
# the encoder: Megatron-SP, and sp beside pp or ep
# ---------------------------------------------------------------------------


def case_forward(mesh_spec, init, res):
    """The forward logits and every leaf's gradient (the mean cross entropy
    of the global batch) with the blocks cut over ``mdl``, the sequence
    gathers of a forward, the shards held, and ``sharded_norm`` of the
    gradient shards against the norm of the whole gradients."""
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import parallel
    from betty_tpu_torch.parallel import collectives

    mesh = parallel.make_mesh(parallel.mesh_shape(mesh_spec))
    module = ppi.pipelined_module(mesh_spec, sp=True)
    ids, y = ppi.data(64, 0)
    rows = slice(mesh.batch_index, None, mesh.batch_world)
    ids, y = torch.tensor(ids[rows]), torch.tensor(y[rows]).long()
    params = dict(init["classifier"])
    dims = parallel.state_shard_dims({"params": params}, mesh, "tp", rules=_sp_rules())["params"]
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
                 "norm": norm, "whole_norm": whole_norm}}


def case_programs(mesh_spec, init, res, rank, programs):
    """The programs on ``mesh_spec`` against the port's one-process run and,
    in the test, JAX's."""
    for program in programs:
        want = _rank0_reference(rank, lambda: engine(program, None, init))
        eng = engine(program, mesh_spec, init)
        gathers = run_counting_gathers(eng)
        _compare(res, program, rank, ppi.whole_params(eng), want, gathers=gathers)


def case_details(mesh_spec, init, work_dir, res):
    """Compiled blocks against driver mode, and a run cut mid-unroll and
    auto-resumed (Adam) against the uninterrupted one, with the shards of the
    parameters and the moments held."""
    import torch

    from betty_tpu_torch import optim

    runs, runner = {}, None
    for compiled in (False, True):
        eng = engine("tp:darts", mesh_spec, init, iters=8, compile_blocks=compiled)
        eng.run()
        runs[compiled] = ppi.whole_params(eng)
        runner = eng.block_runner
    res["compiled"] = {"ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
                       and runner.periods_run > 0,
                       "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                                "periods": getattr(runner, "periods_run", 0)}}

    cut = os.path.join(work_dir, "sp_mdl_checkpoint")

    def run(**kw):
        return engine("tp:darts", mesh_spec, init, iters=4, optimizer=optim.adam(lr=1e-3), **kw)

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


def case_encoder_repeats(init, res, rank):
    """The encoder built with ``seq_axis="sp"`` beside an axis it does not
    split: ``pp:2,sp:2`` under ``strategy="pp"`` (pipelined, M 2; the sp
    ranks repeat) and ``ep:2,sp:2`` under ``strategy="sp"`` (the ep ranks
    repeat); darts."""
    want = _rank0_reference(rank, lambda: engine("tp:darts", None, init))
    for strategy, mesh_spec, M in (("pp", GROUPS["pp2sp2"], 2), ("sp", EP_SP, None)):
        eng = ppi.port_engine("darts", strategy, mesh_spec, init, M, sp=True)
        held = list(eng.states["classifier"]["params"]["blocks.attn.query.kernel"].shape)
        eng.run()
        _compare(res, f"encoder:{mesh_spec}", rank, ppi.whole_params(eng), want, held=held,
                 strategy=eng.strategy)


# ---------------------------------------------------------------------------
# the MoE: ep x mdl, and ep beside pp or sp
# ---------------------------------------------------------------------------


def case_moe_programs(init, res, rank, meshes):
    """The MoE program on each ``(strategy, mesh)`` against the port's
    one-process run and, in the test, JAX's; the leaves each rank holds."""
    want = _rank0_reference(rank, lambda: moe_engine("default", None, init))
    for strategy, mesh_spec in meshes:
        eng = moe_engine(strategy, mesh_spec, init)
        held = {k: list(v.shape) for k, v in tpi.leaves(eng.states["inner"]["params"]).items()}
        gathers = run_counting_gathers(eng)
        _compare(res, f"moe:{strategy}:{mesh_spec}", rank, ppi.whole_params(eng), want,
                 held=held, gathers=gathers)


def case_moe_compiled(mesh_spec, init, res):
    """The MoE program under tp on ``ep x mdl``, compiled against driver
    mode."""
    runs, runner = {}, None
    for compiled in (False, True):
        eng = moe_engine("tp", mesh_spec, init, ["--train_iters", "8"] +
                         (["--compile_blocks"] if compiled else []))
        eng.run()
        runs[compiled] = ppi.whole_params(eng)
        runner = eng.block_runner
    res["moe:compiled"] = {"ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
                           and runner.periods_run > 0,
                           "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                                    "periods": getattr(runner, "periods_run", 0)}}


def case_moe_layer(mesh_spec, res):
    """``moe_ffn`` on ``ep x mdl`` with its leaves cut by
    ``MOE_COMPOSED_SHARD_RULES`` against one process, at capacities 2
    (tokens dropped), the default (1.25) and T: ``y``, ``aux`` and every
    gradient of ``sum(y * g) + aux``, and which tokens each expert kept."""
    import torch

    from betty_tpu_torch import parallel
    from betty_tpu_torch.models import MOE_COMPOSED_SHARD_RULES, init_moe_params, moe_ffn

    mesh = parallel.make_mesh(parallel.mesh_shape(mesh_spec))
    params = init_moe_params(torch.Generator().manual_seed(0), MOE_DIM, MOE_HIDDEN, MOE_EXPERTS,
                             dtype=torch.float64)
    rng = np.random.RandomState(1)
    x0, g = torch.tensor(rng.randn(MOE_TOKENS, MOE_DIM)), torch.tensor(
        rng.randn(MOE_TOKENS, MOE_DIM))
    dims = parallel.state_shard_dims({"params": {"moe": params}}, mesh, "tp",
                                     rules=MOE_COMPOSED_SHARD_RULES)["params"]["moe"]

    def run(p, bound):
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        x = x0.clone().requires_grad_(True)
        with parallel.active(bound):
            y, aux = moe_ffn(p, x, capacity=cap)
            grads = torch.autograd.grad((y * g).sum() + aux, list(p.values()) + [x])
        return y.detach(), aux.detach(), dict(zip(list(p) + ["x"], grads))

    out = {}
    for cap in (2, None, MOE_TOKENS):
        yw, auxw, gw = run(params, None)
        yg, auxg, gg = run(parallel.mesh.shard_tree(params, dims, mesh, "model"), mesh)
        gw = {**parallel.mesh.shard_tree({k: v for k, v in gw.items() if k != "x"}, dims, mesh,
                                         "model"), "x": gw["x"]}
        dropped_w, dropped_g = (yw == 0).all(1), (yg == 0).all(1)
        out[str(cap)] = {
            "y": float((yg - yw).abs().max()), "aux": abs(float(auxg - auxw)),
            "grad": max(float((gg[k] - gw[k]).abs().max()) for k in gw),
            "dropped": int(dropped_w.sum()), "same_dropped": bool(torch.equal(dropped_w,
                                                                              dropped_g)),
            "held": {k: list(v.shape) for k, v in gg.items()}}
    ok = all(e["y"] <= 1e-12 and e["aux"] <= 1e-12 and e["grad"] <= 1e-12 and e["same_dropped"]
             for e in out.values())
    res["moe:layer"] = {"ok": ok and out["2"]["dropped"] > 0 and out[str(MOE_TOKENS)]["dropped"]
                        == 0, "info": out}


# ---------------------------------------------------------------------------


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    mesh = GROUPS[group]
    res = {}
    t0 = time.time()
    if group in GROUP_PROGRAMS:
        init = tpi.take_over(os.path.join(work_dir, "init.pt"))
        case_forward(mesh, init, res)
        case_programs(mesh, init, res, rank, GROUP_PROGRAMS[group])
        if group == "mdl2sp2":
            case_details(mesh, init, work_dir, res)
    elif group == "pp2sp2":
        case_encoder_repeats(tpi.take_over(os.path.join(work_dir, "init.pt")), res, rank)
    else:
        init = tpi.take_over(os.path.join(work_dir, "init_moe.pt"))
        if group == "ep2mdl2":
            case_moe_programs(init, res, rank, (("tp", mesh), ("ep", mesh)))
            case_moe_compiled(mesh, init, res)
            case_moe_layer(mesh, res)
        else:
            case_moe_programs(init, res, rank, (("ep", mesh), ("ep", EP_SP)))
    res["seconds"] = round(time.time() - t0, 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


REF_TIMEOUT = 300


def launch(work):
    """The JAX references (``torch_pp_impl.py``'s three and
    ``torch_tp_impl.py``'s ``ref_moe``) and every group's ranks side by side
    (torchrun's variables, gloo, one thread a process); waits for all of
    them (a failure or a timeout raises) and loads their JSON results."""
    import subprocess

    from test_torch_parallel import _env, _free_port

    procs = []
    refs = [(f"ref_{case}", [os.path.join(HERE, "torch_pp_impl.py"), "ref",
                             os.path.join(work, f"ref_{case}.json"), case])
            for case in ppi.REF_CASES]
    refs.append(("ref_moe", [os.path.join(HERE, "torch_tp_impl.py"), "ref_moe",
                             os.path.join(work, "ref_moe.json")]))
    for name, argv in refs:
        procs.append((name, subprocess.Popen([sys.executable] + argv, env=_env(),
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True)))
    for group, world in WORLDS.items():
        port = _free_port()
        for rank in range(world):
            env = _env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append((f"{group} rank {rank}", subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "rank",
                 os.path.join(work, f"{group}.json"), work, group], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs, deadline = {}, time.time() + REF_TIMEOUT
    try:
        for name, p in procs:
            try:
                outputs[name] = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} passed the {REF_TIMEOUT} s limit")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs:
        assert p.returncode == 0, f"{name} failed:\n{outputs[name][-4000:]}"
    return {name: json.load(open(os.path.join(work, f"{name}.json")))
            for name in [n for n, _ in refs] + list(WORLDS)}


if __name__ == "__main__":
    run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
