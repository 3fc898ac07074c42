"""Tensor and expert parallelism of the port on the CPU over gloo, in
float64, against the JAX package's unsharded runs and the port's own
one-process runs. Run by test_torch_tp.py and test_torch_ep.py.

    python tests/torch_tp_impl.py ref OUT.json SOLVER
        The JAX package's bert_data_reweighting at tests/test_tp.py's
        BASE_ARGS, one process, unsharded (x64, unshuffled loaders, dropout
        0, 4 iterations) under SOLVER (darts, sama, cg, neumann); the final
        and initial parameters in the port's layout. ``darts`` also hands the
        initial weights over in OUT's directory.

    python tests/torch_tp_impl.py ref_moe OUT.json
        tests/test_ep.py's bilevel MoE program, unsharded (x64, 4
        iterations, tests/torch_moe_impl.py's construction); hands its
        initial weights over.

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_tp_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port. GROUP ``mdl2`` (2 ranks, mesh dp:1,mdl:2):
        the bert program under tp for darts, SAMA, CG (plain and fused) and
        Neumann against the port's one-process run, dropout 0.1, the shards
        each rank holds and the model-axis collectives of an update,
        compiled blocks against driver mode, a run cut and auto-resumed;
        ``dp2mdl2`` (4 ranks, dp:2,mdl:2): the solvers again; ``ep2`` (2
        ranks, ep:2) and ``dp2ep2`` (4 ranks, dp:2,ep:2): the MoE program
        under ep (and under tp with ``shard_rules`` naming ``ep``), the
        expert leaves each rank holds, and ep on a program without an MoE.
        Rank 0 writes the results.
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

# tests/test_tp.py's BASE_ARGS, float32 there, float64 here, dropout 0
BASE_ARGS = ["--batch_size", "16", "--seq_len", "16", "--dim", "64", "--depth", "2",
             "--heads", "4", "--train_size", "128", "--meta_size", "64", "--unroll_steps", "2",
             "--precision", "fp32", "--dropout", "0", "--train_iters", "4"]
GLOBAL_BATCH = 16
SOLVERS = {  # name: (hypergradient, solver config of the classifier)
    "darts": ("darts", {}),
    "sama": ("sama", {}),
    "cg": ("cg", {"cg_iterations": 2}),
    "cg_fused": ("cg", {"cg_iterations": 2, "use_fused_vector_ops": True}),
    "neumann": ("neumann", {"neumann_iterations": 2}),
}
MOE_ARGV = ["--dim", "16", "--hidden", "32", "--experts", "4", "--tokens", "64",
            "--val_tokens", "32", "--dense", "--train_iters", "4", "--device", "cpu"]


# ---------------------------------------------------------------------------
# the JAX package's references
# ---------------------------------------------------------------------------


def run_ref(out, solver):
    import jax
    import torch

    from betty_tpu_torch import convert

    jax.config.update("jax_enable_x64", True)
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    mod = tpi._jax_module("bert_tp_ref", os.path.join(
        os.path.dirname(HERE), "examples", "bert_data_reweighting", "main.py"))
    hyper, cfg = SOLVERS[solver]
    engine = mod.build_engine(mod.parse_args(BASE_ARGS + ["--hypergradient", hyper]))
    engine.states = tpi._f64_jax(engine.states)
    for k, v in cfg.items():
        setattr(engine.classifier.config, k, v)

    def port(states):
        return {"classifier": convert.from_flax_transformer(
                    numpy(states["classifier"]["params"]), dtype=torch.float64),
                "reweight": convert.from_flax_mwn(numpy(states["reweight"]["params"]),
                                                  dtype=torch.float64)}

    init = port(engine.states)
    if solver == "darts":
        tpi.hand_over(os.path.join(os.path.dirname(out), "init_bert.pt"), init)
    tpi.unshuffle(engine.problems)
    engine.run()
    with open(out, "w") as f:
        json.dump({"final": {n: tpi._lists(t) for n, t in port(engine.states).items()},
                   "init": {n: tpi._lists(t) for n, t in init.items()}}, f)
    print("REF_OK", flush=True)


def run_ref_moe(out):
    import torch_moe_impl

    jeng = torch_moe_impl.jax_program()
    tpi.hand_over(os.path.join(os.path.dirname(out), "init_moe.pt"),
                  torch_moe_impl.port_params(jeng.states))
    jeng.run()
    final = torch_moe_impl.port_params(jeng.states)
    with open(out, "w") as f:
        json.dump({n: {k: v.tolist() for k, v in tpi.leaves(t).items()}
                   for n, t in final.items()}, f)
    print("REF_OK", flush=True)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _f64_states(engine):
    import torch

    from betty_tpu_torch.utils import tree_map

    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)


def bert_engine(solver, strategy, mesh, init, extra=()):
    """The bert program (BASE_ARGS) from the JAX package's initial weights,
    float64, unshuffled; each of the mesh's dp ranks loads its share of the
    global batch of 16."""
    from betty_tpu_torch import parallel
    from betty_tpu_torch.examples import bert_data_reweighting as tex

    hyper, cfg = SOLVERS[solver]
    dp = dict(parallel.mesh_shape(mesh) or (("dp", 1),))["dp"]
    argv = BASE_ARGS + ["--device", "cpu", "--hypergradient", hyper, "--strategy", strategy,
                        "--batch_size", str(GLOBAL_BATCH // dp)] + (
        ["--mesh", mesh] if mesh else []) + list(extra)
    engine = tex.build_engine(tex.parse_args(argv), **cfg)
    _f64_states(engine)
    for p in engine.problems:
        st = dict(engine.states[p.name])
        st["params"] = p.shard_full_state({"params": init[p.name]})["params"]
        engine.states[p.name] = st
    tpi.unshuffle(engine.problems)
    return engine


def whole_params(engine):
    return {p.name: p.full_state()["params"] for p in engine.problems}


def count_collectives(mesh):
    """Counts of the model-group and other collective calls while the
    returned dict is live (``torch.distributed`` wrapped in place); call
    ``restore()`` after."""
    import torch.distributed as dist

    counts = {}
    saved = {}
    for name in ("all_reduce", "all_gather_into_tensor"):
        orig = saved[name] = getattr(dist, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            group = kw.get("group", a[2] if len(a) > 2 else None)
            key = f"{_name}:{'model' if group is mesh.model_group else 'other'}"
            counts[key] = counts.get(key, 0) + 1
            return _orig(*a, **kw)

        setattr(dist, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)

    return counts, restore


def case_solvers(group, mesh, init, res, rank):
    """Each solver under tp against the port's one-process run (rank 0
    runs that) and, in the test, against the JAX package's."""
    for solver in SOLVERS:
        want = None
        if rank == 0:
            ref = bert_engine(solver, "default", None, init)
            ref.run()
            want = whole_params(ref)
        engine = bert_engine(solver, "tp", mesh, init)
        engine.run()
        got = whole_params(engine)
        if rank == 0:
            err = tpi.max_err(got, want)
            res[f"tp:{solver}"] = {"ok": err <= 1e-12, "info": {"max_abs_err": err},
                                   "params": {n: tpi._lists(t) for n, t in got.items()}}


def hooked_run(engine):
    """Run ``engine`` with hooks on the classifier that read whole trees and
    edit across the heads axis; returns the whole parameters and the hooks'
    log (norms, then the query kernel's shape as the hook saw it)."""
    from betty_tpu_torch.utils import tree_leaves, tree_map

    clf = engine.classifier
    other = next(p for p in engine.problems if p is not clf)
    log = []

    def sq(tree):
        return float(sum((t.detach() * t.detach()).sum() for t in tree_leaves(tree)))

    def grad_callback():
        g = clf.grads
        norm = sq(g) ** 0.5
        clf.set_grads_value(tree_map(lambda t: t / (1.0 + norm), g))
        q = clf.params["blocks.0.attn.query.kernel"]
        log.append([norm, sq(clf.params), sq(other.params), list(q.shape)])

    def param_callback():
        p = clf.params
        q = p["blocks.0.attn.query.kernel"]
        clf.set_params({**p, "blocks.0.attn.query.kernel": q - 0.1 * q.mean(1, keepdim=True)})
        log.append([sq(p), list(q.shape)])

    clf.grad_callback, clf.param_callback = grad_callback, param_callback
    engine.run()
    return whole_params(engine), log


def case_details(mesh_spec, init, work_dir, res, rank):
    """Dropout, the shards held, the collectives of an update, compiled
    blocks, checkpoints (mesh dp:1,mdl:2)."""
    import torch

    from betty_tpu_torch import parallel

    # dropout 0.1: every model rank draws the unsharded run's masks
    runs = {}
    for strategy, mesh in (("default", None), ("tp", mesh_spec)):
        engine = bert_engine("sama", strategy, mesh, init, extra=["--dropout", "0.1"])
        engine.run()
        runs[strategy] = whole_params(engine)
    err = tpi.max_err(runs["tp"], runs["default"])
    res["dropout"] = {"ok": err <= 1e-12, "info": {"max_abs_err": err}}

    # grad_callback and param_callback see whole tensors under tp, as in one
    # process: each takes a norm over whole trees (its own and the other
    # problem's) and edits across the sharded heads axis
    runs, seen = {}, {}
    for strategy, mesh in (("default", None), ("tp", mesh_spec)):
        if strategy == "default" and rank != 0:
            continue
        engine = bert_engine("darts", strategy, mesh, init)
        runs[strategy], seen[strategy] = hooked_run(engine)
    if rank == 0:
        err = tpi.max_err(runs["tp"], runs["default"])
        logs = [abs(a - b) for x, y in zip(seen["tp"], seen["default"])
                for a, b in zip(x[:-1], y[:-1])]
        same = len(seen["tp"]) == len(seen["default"]) > 0
        res["hooks"] = {"ok": same and err <= 1e-12 and max(logs) <= 1e-12,
                        "info": {"max_abs_err": err, "log_err": max(logs),
                                 "calls": len(seen["tp"]),
                                 "shapes": sorted({tuple(x[-1]) for x in seen["tp"]})}}

    # the shards each rank holds, and the collectives of one classifier update
    engine = bert_engine("darts", "tp", mesh_spec, init)
    clf = engine.classifier
    held = {k: list(v.shape) for k, v in engine.states["classifier"]["params"].items()}
    opt_held = {k: list(v.shape) for k, v in
                engine.states["classifier"]["opt_state"]["mu"].items()}
    counts, restore = count_collectives(engine.mesh)
    try:
        engine.train()
        clf._count += 1
        clf.one_step_descent()
        forward_counts = dict(counts)
        counts.clear()
        with torch.no_grad():
            clf(clf.cur_batch[0])
        eval_counts = dict(counts)
    finally:
        restore()
    res["sharding"] = {"ok": True, "info": {
        "held": held, "opt_held": opt_held, "update_collectives": forward_counts,
        "forward_collectives": eval_counts,
        "dims": {k: v for k, v in clf._shard_dims["params"].items()}}}

    # compiled blocks against driver mode (the CPU runner: eager periods)
    runs = {}
    for compiled in (False, True):
        engine = bert_engine("sama", "tp", mesh_spec, init, extra=[
            "--train_iters", "8"] + (["--compile_blocks"] if compiled else []))
        engine.run()
        runs[compiled] = whole_params(engine)
    runner = engine.block_runner
    res["compiled"] = {"ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
                       and runner.periods_run > 0,
                       "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                                "periods": getattr(runner, "periods_run", 0)}}

    # a run cut after 3 steps (mid-unroll) and auto-resumed
    cut = os.path.join(work_dir, "tp_checkpoint")
    straight = bert_engine("sama", "tp", mesh_spec, init)
    straight.run()
    first = bert_engine("sama", "tp", mesh_spec, init)
    first.train_iters = 3
    first.config.checkpoint_step, first.config.checkpoint_dir = 3, cut
    first.run()
    resumed = bert_engine("sama", "tp", mesh_spec, init)
    resumed.config.checkpoint_dir, resumed.config.auto_resume = cut, True
    resumed.run()
    a, b = whole_params(straight), whole_params(resumed)
    saved = torch.load(os.path.join(cut, "step_3.pt"), weights_only=True)
    whole_saved = list(saved["classifier"]["params"]["blocks.0.attn.query.kernel"].shape)
    res["resume"] = {"ok": tpi.bit_equal(a, b) and resumed.global_step == 4,
                     "info": {"max_abs_err": tpi.max_err(a, b),
                              "global_step": resumed.global_step,
                              "saved_query_kernel": whole_saved}}
    parallel.mesh  # noqa: B018 (the package stays imported for the ranks' groups)


def moe_engine(strategy, mesh, init, extra=()):
    import torch

    from betty_tpu_torch.examples import moe_reweighting as tex
    from betty_tpu_torch.utils import tree_map

    engine = tex.build_engine(tex.parse_args(MOE_ARGV + ["--strategy", strategy] + (
        ["--mesh", mesh] if mesh else []) + list(extra)))
    _f64_states(engine)
    for p in engine.problems:
        st = dict(engine.states[p.name])
        st["params"] = p.shard_full_state({"params": tree_map(torch.clone, init[p.name])})[
            "params"]
        engine.states[p.name] = st
        (xb, yb), = p.train_data_loader[0]
        p.train_data_loader[0][0] = (xb.double(), yb)
    return engine


def case_moe(mesh_spec, init, res, rank):
    """The MoE program under ep and under tp with ``shard_rules`` naming
    ``ep``, against the port's one-process run; the expert leaves held; ep
    on a program without an MoE raises."""
    import torch

    from betty_tpu_torch import parallel
    from betty_tpu_torch.examples import bert_data_reweighting as bert

    want = None
    if rank == 0:
        ref = moe_engine("default", None, init)
        ref.run()
        want = whole_params(ref)
    for strategy in ("ep", "tp"):
        engine = moe_engine(strategy, mesh_spec, init)
        held = {k: list(v.shape) for k, v in tpi.leaves(
            engine.states["inner"]["params"]).items()}
        engine.run()
        got = whole_params(engine)
        if rank == 0:
            err = tpi.max_err(got, want)
            res[f"moe:{strategy}"] = {
                "ok": err <= 1e-12, "info": {"max_abs_err": err, "held": held},
                "params": {n: {k: v.tolist() for k, v in tpi.leaves(t).items()}
                           for n, t in got.items()}}
    try:
        bert.build_engine(bert.parse_args(["--device", "cpu", "--dim", "16", "--depth", "1",
                                           "--heads", "2", "--seq_len", "8", "--train_size",
                                           "32", "--meta_size", "16", "--batch_size", "8"]
                                          + ["--strategy", "default", "--mesh", mesh_spec]))
        raised = "no"
    except ValueError as e:
        raised = str(e)
    from betty_tpu_torch import Engine, EngineConfig
    try:
        from betty_tpu_torch.examples import logistic_regression_hpo as lr
        from betty_tpu_torch.module import from_fn
        outer = lr.Outer("outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(4)}),
                         optimizer=None, train_data_loader=[(torch.zeros(2, 4), torch.zeros(2))])
        Engine(config=EngineConfig(strategy="ep", mesh_shape=tuple(
            parallel.mesh_shape(mesh_spec))), problems=[outer], device="cpu")
        no_moe = "no"
    except ValueError as e:
        no_moe = str(e)
    res["moe:raises"] = {"ok": "strategy 'tp' or 'ep'" in raised and "nothing to shard" in no_moe,
                         "info": {"dp_strategy_on_ep_mesh": raised, "ep_without_moe": no_moe}}


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    res = {}
    t0 = time.time()
    if group in ("mdl2", "dp2mdl2"):
        init = tpi.take_over(os.path.join(work_dir, "init_bert.pt"))
        mesh = "dp:1,mdl:2" if group == "mdl2" else "dp:2,mdl:2"
        case_solvers(group, mesh, init, res, rank)
        if group == "mdl2":
            case_details(mesh, init, work_dir, res, rank)
    else:
        init = tpi.take_over(os.path.join(work_dir, "init_moe.pt"))
        case_moe("dp:1,ep:2" if group == "ep2" else "dp:2,ep:2", init, res, rank)
    res["seconds"] = round(time.time() - t0, 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_ref(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "ref_moe":
        run_ref_moe(sys.argv[2])
    else:
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
