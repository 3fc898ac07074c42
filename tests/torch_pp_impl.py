"""Pipeline and sequence parallelism of the port on the CPU over gloo, in
float64, against the JAX package's sequential runs and the port's own
one-process runs. Run by test_torch_pipeline.py and test_torch_sp.py.

    python tests/torch_pp_impl.py ref OUT.json CASE
        The JAX package's ``make_pipelined_transformer`` at
        tests/test_pp.py's CFG widths, sequential (no mesh), x64. CASE
        ``darts``: the forward logits and every leaf's gradient of a mean
        cross entropy on tests/test_pp.py's data, then tests/test_pp.py's
        ``_run_engine`` bilevel program (darts, unroll 2, 3 iterations);
        it hands the initial weights over in OUT's directory. ``cg_jvp`` and
        ``cg_vjp``: the same program under CG with that ``hvp_mode``.

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_pp_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port. GROUP ``pp2`` (``dp:1,pp:2``, M 2),
        ``dp2pp2`` (``dp:2,pp:2``, M 4), ``sp2`` (``dp:1,sp:2``) or
        ``dp2sp2`` (``dp:2,sp:2``): the forward and gradients, the three
        programs (pp under ``strategy="pp"``, darts also under ``"tp"`` with
        ``shard_rules``; sp under ``"sp"`` and ``"dp"``), each against the
        port's one-process run too. ``pp2`` and ``sp2`` add tutorial 7's mode
        against ``--mesh none``, compiled blocks against driver mode and a
        run cut and auto-resumed; ``pp2`` the shards held, the ring shifts
        of a forward and the JAX package's loud errors. Rank 0 writes the
        results.
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

# tests/test_pp.py's CFG and data
CFG = dict(vocab_size=64, max_len=8, dim=16, depth=4, heads=2, num_classes=2, pad_id=1)
ITERS, UNROLL = 3, 2
SOLVERS = {"darts": dict(type="darts"),
           "cg_jvp": dict(type="cg", cg_iterations=2, hvp_mode="jvp"),
           "cg_vjp": dict(type="cg", cg_iterations=2, hvp_mode="vjp")}
GROUPS = {"pp2": ("dp:1,pp:2", 2), "dp2pp2": ("dp:2,pp:2", 4),
          "sp2": ("dp:1,sp:2", None), "dp2sp2": ("dp:2,sp:2", None)}  # (mesh, M)
PP_RULES = ((r"^blocks", ("pp",)),)


def data(n=64, seed=0):
    """tests/test_pp.py's ``_data``: token ids with the last two padded."""
    r = np.random.RandomState(seed)
    ids = r.randint(2, CFG["vocab_size"], size=(n, CFG["max_len"]))
    ids[:, -2:] = 1
    y = r.randint(0, 2, size=n)
    return ids.astype(np.int32), y.astype(np.int32)


# ---------------------------------------------------------------------------
# the JAX package's references
# ---------------------------------------------------------------------------


def jax_engine(case):
    import jax
    import jax.numpy as jnp
    import optax

    from betty_tpu import Config, Engine, EngineConfig, ImplicitProblem, optim
    from betty_tpu.models import MetaWeightNet, make_pipelined_transformer
    from betty_tpu.module import from_flax

    class Reweight(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            return optax.softmax_cross_entropy_with_integer_labels(self.classifier(ids),
                                                                   y).mean()

    class Classifier(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            ce = optax.softmax_cross_entropy_with_integer_labels(self.module(ids), y)
            return jnp.mean(self.reweight(jax.lax.stop_gradient(ce)) * ce)

    (ids, y), (mids, my) = data(64, 0), data(32, 1)
    module = make_pipelined_transformer(None, **CFG, rng=jax.random.PRNGKey(0))
    mwn = from_flax(MetaWeightNet(), jnp.zeros((8,)), rng=jax.random.PRNGKey(1),
                    train_kwarg="train")
    clf = Classifier("classifier", module=module, optimizer=optim.sgd(lr=0.05),
                     train_data_loader=[(jnp.asarray(ids), jnp.asarray(y))],
                     config=Config(unroll_steps=UNROLL, **SOLVERS[case]))
    rw = Reweight("reweight", module=mwn, optimizer=optim.adam(lr=1e-3),
                  train_data_loader=[(jnp.asarray(mids), jnp.asarray(my))], config=Config())
    engine = Engine(config=EngineConfig(train_iters=ITERS), problems=[rw, clf],
                    dependencies={"u2l": {rw: [clf]}, "l2u": {clf: [rw]}})
    engine.states = tpi._f64_jax(engine.states)
    return engine, module


def run_ref(out, case):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from betty_tpu_torch import convert

    jax.config.update("jax_enable_x64", True)
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    engine, module = jax_engine(case)

    def port(states):
        return {"classifier": convert.from_jax_pipelined(
                    numpy(states["classifier"]["params"]), dtype=torch.float64),
                "reweight": convert.from_flax_mwn(numpy(states["reweight"]["params"]),
                                                  dtype=torch.float64)}

    init = port(engine.states)
    res = {}
    if case == "darts":
        tpi.hand_over(os.path.join(os.path.dirname(out), "init.pt"), init)
        params = engine.states["classifier"]["params"]
        ids, y = data(64, 0)

        def loss(p):
            logits = module.apply({"params": p}, jnp.asarray(ids), train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y)).mean(), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        res["logits"] = np.asarray(logits).tolist()
        res["grads"] = tpi._lists(convert.from_jax_pipelined(numpy(grads),
                                                             dtype=torch.float64))
    engine.run()
    res["final"] = {n: tpi._lists(t) for n, t in port(engine.states).items()}
    res["init"] = {n: tpi._lists(t) for n, t in init.items()}
    with open(out, "w") as f:
        json.dump(res, f)
    print("REF_OK", flush=True)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _classes():
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import ImplicitProblem

    class Reweight(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            return F.cross_entropy(self.classifier(ids), y.long())

    class Classifier(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            ce = F.cross_entropy(self.module(ids), y.long(), reduction="none")
            return torch.mean(self.reweight(ce.detach()) * ce)

    return Reweight, Classifier


def pipelined_module(mesh_spec, M=None, sp=False):
    """``make_pipelined_transformer`` at CFG in float64: pipelined over the
    mesh's pp axis, sequence-parallel over its sp axis (``sp``), or
    sequential without a mesh."""
    import torch

    from betty_tpu_torch import parallel
    from betty_tpu_torch.models import make_pipelined_transformer

    return make_pipelined_transformer(parallel.mesh_shape(mesh_spec), **CFG, num_microbatches=M,
                                      seq_axis="sp" if sp else None, dtype=torch.float64)


def port_engine(case, strategy, mesh_spec, init, M=None, sp=False, iters=ITERS, rules=None,
                **engine_kw):
    """tests/test_pp.py's ``_run_engine`` program on the port, float64,
    from the JAX package's initial weights; each batch rank loads its rows
    ``index::count`` of the global batch. ``rules``: the classifier's
    ``shard_rules`` under ``"tp"`` (default ``PP_RULES``)."""
    import torch

    from betty_tpu_torch import Config, Engine, EngineConfig, optim, parallel
    from betty_tpu_torch.models import MetaWeightNet
    from betty_tpu_torch.module import from_torch
    from betty_tpu_torch.utils import tree_map

    Reweight, Classifier = _classes()
    shape = parallel.mesh_shape(mesh_spec)
    index, count = parallel.batch_coordinates(shape) if mesh_spec else (0, 1)
    rows = slice(index, None, count)

    def loader(n, seed):
        ids, y = data(n, seed)
        return [(torch.tensor(ids[rows]), torch.tensor(y[rows]))]

    clf = Classifier("classifier", module=pipelined_module(mesh_spec, M, sp),
                     optimizer=engine_kw.pop("optimizer", optim.sgd(lr=0.05)),
                     train_data_loader=loader(64, 0),
                     config=Config(unroll_steps=UNROLL, **SOLVERS[case],
                                   shard_rules=(rules or PP_RULES) if strategy == "tp" else None))
    rw = Reweight("reweight", module=from_torch(MetaWeightNet()),
                  optimizer=optim.adam(lr=1e-3), train_data_loader=loader(32, 1),
                  config=Config())
    engine = Engine(config=EngineConfig(train_iters=iters, strategy=strategy,
                                        mesh_shape=shape, autoshard_data=False, **engine_kw),
                    problems=[rw, clf],
                    dependencies={"u2l": {rw: [clf]}, "l2u": {clf: [rw]}}, device="cpu")
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    for p in engine.problems:
        st = dict(engine.states[p.name])
        st["params"] = p.shard_full_state({"params": tree_map(torch.clone, init[p.name])})[
            "params"]
        engine.states[p.name] = st
    return engine


def whole_params(engine):
    return {p.name: p.full_state()["params"] for p in engine.problems}


def case_forward(mesh_spec, M, sp, init, res, rank):
    """The forward logits and every leaf's gradient (the mean cross entropy
    of the global batch), and the ring shifts or gathers a forward makes."""
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import parallel
    from betty_tpu_torch.parallel import collectives

    mesh = parallel.make_mesh(parallel.mesh_shape(mesh_spec))
    module = pipelined_module(mesh_spec, M, sp)
    ids, y = data(64, 0)
    rows = slice(mesh.batch_index, None, mesh.batch_world)
    ids, y = torch.tensor(ids[rows]), torch.tensor(y[rows]).long()
    params = dict(init["classifier"])
    dims = parallel.state_shard_dims({"params": params}, mesh, "pp")["params"] if not sp \
        else None
    if dims:
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
    if dims:
        grads = parallel.gather_shards(grads, dims, mesh, "model")
    all_logits = parallel.mesh.make_global_batch(logits.detach(), mesh)
    # rows index::count of each batch rank, back in the global batch's order
    order = torch.empty_like(all_logits)
    w = mesh.batch_world
    for b in range(w):
        order[b::w] = all_logits[b * (64 // w):(b + 1) * (64 // w)]
    res["forward"] = {"ok": True, "info": {"calls": calls,
                                           "held": {k: list(v.shape) for k, v in params.items()}},
                      "logits": order.tolist(), "grads": tpi._lists(grads)}


def case_programs(mesh_spec, M, sp, init, res, rank):
    """The darts and CG programs under the slice's strategies, against the
    port's one-process run (rank 0 runs it) and, in the test, JAX's."""
    strategies = ("sp", "dp") if sp else ("pp", "tp")
    for case in SOLVERS:
        want = None
        if rank == 0:
            ref = port_engine(case, "default", None, init)
            ref.run()
            want = whole_params(ref)
        for strategy in strategies[:1] if case != "darts" else strategies:
            engine = port_engine(case, strategy, mesh_spec, init, M, sp)
            engine.run()
            got = whole_params(engine)
            if rank == 0:
                err = tpi.max_err(got, want)
                res[f"{strategy}:{case}"] = {
                    "ok": err <= 1e-12, "info": {"max_abs_err": err},
                    "params": {n: tpi._lists(t) for n, t in got.items()}}


def case_details(mesh_spec, M, sp, init, work_dir, res, rank):
    """Tutorial 7's mode against ``--mesh none``, compiled blocks against
    driver mode, a run cut mid-unroll and auto-resumed; under pp the shards
    and Adam moments held."""
    import importlib

    import torch

    from betty_tpu_torch import optim
    from betty_tpu_torch.utils import tree_leaves, tree_map

    t7 = importlib.import_module("betty_tpu_torch.tutorial.7_model_parallelism")
    mode = "sp" if sp else "pp"

    def t7_run(mesh):
        engine = t7.build_engine(t7.parse_args(["--device", "cpu", "--mode", mode, "--mesh", mesh,
                                                "--train_iters", "4"]))
        engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                                 and t.is_floating_point() else t, engine.states)
        start = [x.clone() for x in tree_leaves(whole_params(engine))]
        engine.run()
        return start, tree_leaves(whole_params(engine)), engine

    _, got, engine = t7_run(mesh_spec)
    held = {k: list(v.shape) for k, v in engine.states["classifier"]["params"].items()}
    moments = {k: list(v.shape) for k, v in engine.states["classifier"]["opt_state"]["mu"].items()}
    if rank == 0:
        start, want, _ = t7_run("none")
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        moved = max(float((a - b).abs().max()) for a, b in zip(want, start))
        res["tutorial"] = {"ok": err <= 1e-12 and moved > 0,
                           "info": {"max_abs_err": err, "moved": moved, "held": held,
                                    "moments": moments}}

    # compiled blocks against driver mode (the CPU runner: eager periods)
    runs, runner = {}, None
    for compiled in (False, True):
        engine = port_engine("darts", "sp" if sp else "pp", mesh_spec, init, M, sp, iters=8,
                             compile_blocks=compiled)
        engine.run()
        runs[compiled] = whole_params(engine)
        runner = engine.block_runner
    res["compiled"] = {"ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
                       and runner.periods_run > 0,
                       "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                                "periods": getattr(runner, "periods_run", 0)}}

    # a run cut after 3 steps (mid-unroll) and auto-resumed, Adam on the blocks
    cut = os.path.join(work_dir, f"{mode}_checkpoint")
    strategy = "sp" if sp else "pp"

    def engine(**kw):
        return port_engine("darts", strategy, mesh_spec, init, M, sp, iters=4,
                           optimizer=optim.adam(lr=1e-3), **kw)

    straight = engine()
    straight.run()
    first = engine(checkpoint_step=3, checkpoint_dir=cut)
    first.train_iters = 3
    first.run()
    resumed = engine(checkpoint_dir=cut, auto_resume=True)
    resumed.run()
    a, b = whole_params(straight), whole_params(resumed)
    saved = torch.load(os.path.join(cut, "step_3.pt"), weights_only=True)
    res["resume"] = {"ok": tpi.bit_equal(a, b) and resumed.global_step == 4,
                     "info": {"max_abs_err": tpi.max_err(a, b),
                              "global_step": resumed.global_step,
                              "saved_query_kernel": list(saved["classifier"]["params"]
                                                         ["blocks.attn.query.kernel"].shape),
                              "held": list(straight.states["classifier"]["params"]
                                           ["blocks.attn.query.kernel"].shape),
                              "moment_held": list(straight.states["classifier"]["opt_state"]
                                                  ["mu"]["blocks.attn.query.kernel"].shape)}}


def case_errors(mesh_spec, init, res):
    """The JAX package's loud errors (tests/test_composed.py:113-130,
    192-228) with the same kinds and subjects, on a pp mesh."""
    import torch

    from betty_tpu_torch import Config, Engine, EngineConfig, optim, parallel
    from betty_tpu_torch.models import MetaWeightNet, TransformerClassifier
    from betty_tpu_torch.module import from_torch

    Reweight, Classifier = _classes()
    shape = parallel.mesh_shape(mesh_spec)
    out = {}

    def build(strategy, mesh, module):
        ids, y = data(64, 0)
        clf = Classifier("classifier", module=module, optimizer=optim.sgd(lr=0.05),
                         train_data_loader=[(torch.tensor(ids), torch.tensor(y))],
                         config=Config(type="darts", unroll_steps=2))
        rw = Reweight("reweight", module=from_torch(MetaWeightNet()),
                      optimizer=optim.adam(lr=1e-3),
                      train_data_loader=[(torch.tensor(ids), torch.tensor(y))], config=Config())
        return Engine(config=EngineConfig(train_iters=1, strategy=strategy, mesh_shape=mesh),
                      problems=[rw, clf], dependencies={"u2l": {rw: [clf]}, "l2u": {clf: [rw]}},
                      device="cpu")

    flat = from_torch(TransformerClassifier(vocab_size=64, max_len=8, dim=16, depth=2, heads=2,
                                            dropout=0.0))
    for name, (strategy, mesh, module) in {
            "pp_without_axis": ("pp", (("dp", 2),), pipelined_module(None)),
            "pp_without_blocks": ("pp", shape, flat),
            "sp_without_axis": ("sp", (("dp", 2),), pipelined_module(None, sp=True)),
            "ep_without_moe": ("ep", (("dp", 1), ("ep", 2)), pipelined_module(None))}.items():
        try:
            build(strategy, mesh, module)
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    # the depth must divide over the stages, as JAX's rule says
    try:
        parallel.state_shard_dims({"params": {"blocks.w": torch.zeros(3, 4)}},
                                  parallel.make_mesh(shape), "pp")
        out["odd_depth"] = "no error"
    except ValueError as e:
        out["odd_depth"] = f"ValueError: {e}"
    res["errors"] = {"ok": True, "info": out}


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    init = tpi.take_over(os.path.join(work_dir, "init.pt"))
    mesh, M = GROUPS[group]
    sp = group.endswith("sp2")
    res = {}
    t0 = time.time()
    case_forward(mesh, M, sp, init, res, rank)
    case_programs(mesh, M, sp, init, res, rank)
    if group in ("pp2", "sp2"):
        case_details(mesh, M, sp, init, work_dir, res, rank)
    if group == "pp2":
        case_errors(mesh, init, res)
    res["seconds"] = round(time.time() - t0, 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


# ---------------------------------------------------------------------------
# the launcher of the test files
# ---------------------------------------------------------------------------

REF_CASES = tuple(SOLVERS)
TIMEOUT = 300


def launch(work, groups, script=None, worlds=None):
    """Start the three JAX references and the rank groups ``groups`` (names
    of ``GROUPS``) side by side (torchrun's variables, gloo, one thread a
    process), wait for all of them (a failure or a timeout raises) and load
    their JSON results. ``script``: the file whose ``rank`` mode the ranks
    run (default this one); ``worlds``: each group's ranks (default 4 for a
    ``dp2`` group, else 2)."""
    import subprocess

    from test_torch_parallel import _env, _free_port

    procs = []
    for case in REF_CASES:
        procs.append((f"ref_{case}", subprocess.Popen(
            [sys.executable, __file__, "ref", os.path.join(work, f"ref_{case}.json"), case],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for group in groups:
        world = worlds[group] if worlds else 4 if group.startswith("dp2") else 2
        port = _free_port()
        for rank in range(world):
            env = _env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append((f"{group} rank {rank}", subprocess.Popen(
                [sys.executable, script or __file__, "rank", os.path.join(work, f"{group}.json"),
                 work, group], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    outputs, deadline = {}, time.time() + TIMEOUT
    try:
        for name, p in procs:
            try:
                outputs[name] = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} passed the {TIMEOUT} s limit")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs:
        assert p.returncode == 0, f"{name} failed:\n{outputs[name][-4000:]}"
    out = {}
    for name in [f"ref_{c}" for c in REF_CASES] + list(groups):
        with open(os.path.join(work, f"{name}.json")) as fh:
            out[name] = json.load(fh)
    return out


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def tree_err(got, want):
    """The largest |difference| over the leaves of two ``{problem: {leaf:
    list}}`` trees with the same keys."""
    assert got.keys() == want.keys() and all(got[n].keys() == want[n].keys() for n in want)
    return max(err(got[n][k], v) for n in want for k, v in want[n].items())


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_ref(sys.argv[2], sys.argv[3])
    else:
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
