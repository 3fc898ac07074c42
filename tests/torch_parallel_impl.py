"""The port's data-parallel strategies on the CPU over gloo, in float64,
against the JAX package's one-process run on the global batch and against
each other. Run by test_torch_parallel.py.

    python tests/torch_parallel_impl.py ref OUT.json PART
        The JAX package, one process, global batches (x64), PART one of:
        ``fixtures``, the fixtures bilevel program (tests/fixtures.py) under
        darts, SAMA, CG, Neumann, reinforce and ITD; ``bert``, the small
        bert_data_reweighting (SAMA, the weighted loss's normaliser); ``mwn``,
        the small MWN ResNet (darts, BatchNorm). Writes the final
        parameters.

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_parallel_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port (torchrun's variables, or the ``BETTY_*`` ones
        where betty_tpu is not imported). GROUP "two" (2 ranks): the
        fixtures program under dp (each rank loading half the global batch;
        reinforce with the JAX package's directions), under zero and fsdp
        with every leaf sharded (``FSDP_MIN_SIZE`` 1), the shapes each rank
        holds, an fsdp run cut and auto-resumed, and the collectives' own
        checks. GROUP "models" (2 ranks): tutorial 5's program under dp,
        zero and fsdp at the real threshold, and the bert and MWN programs
        under dp from the JAX package's initial weights (which the ``bert``
        and ``mwn`` references hand over in WORK_DIR). GROUP "four" (4
        ranks): fsdp against dp. Rank 0 writes the results.

Every loader is unshuffled, so that the ranks' local batches (examples
``rank::N`` of the one-process run's batch) make the same global batch.
"""

import json
import contextlib
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

GLOBAL_BATCH = 32
ITERS, UNROLL = 8, 2
SOLVERS = {
    "darts": dict(type="darts", darts_alpha=0.01),
    "sama": dict(type="sama", sama_adam_alpha=1.0),
    "cg": dict(type="cg", cg_iterations=3, cg_alpha=0.35),
    "neumann": dict(type="neumann", neumann_iterations=3, neumann_alpha=0.7),
    "reinforce": dict(type="reinforce", reinforce_samples=4, reinforce_sigma=0.05,
                      reinforce_alpha=0.02),
    "itd": dict(type="darts"),
}
BERT_ARGV = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len", "8",
             "--train_size", "64", "--meta_size", "32", "--precision", "fp32", "--dropout", "0",
             "--unroll_steps", "2", "--train_iters", "4", "--hypergradient", "sama"]
MWN_ARGV = ["--train_size", "64", "--meta_size", "32", "--train_iters", "4", "--solver", "darts"]


def fixture_data():
    """Train and validation halves of tests/fixtures.py's data (n 256), the
    float32 values widened to float64."""
    from betty_tpu_torch.examples.logistic_regression_hpo import make_data

    (x, y), (xv, yv) = make_data(seed=0, n=256)
    return [(np.asarray(a, np.float64), np.asarray(b, np.float64)) for a, b in ((x, y), (xv, yv))]


def unshuffle(problems, fresh_iterators=True):
    for p in problems:
        for dl in p.train_data_loader:
            dl.shuffle = False
        if fresh_iterators:
            p.train_data_iterator = [iter(dl) for dl in p.train_data_loader]


def jax_directions(key, n, like):
    """The directions betty_tpu's reinforce draws from ``key``."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(like)
    out = []
    for k in jax.random.split(jax.random.fold_in(key, 0x5E1F), n):
        keys = jax.random.split(k, len(leaves))
        out.append(jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(kk, leaf.shape, leaf.dtype)
                      for kk, leaf in zip(keys, leaves)]))
    return out


# ---------------------------------------------------------------------------
# the JAX package's references
# ---------------------------------------------------------------------------


def _f64_jax(tree):
    import jax

    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if getattr(a, "dtype", None) == np.float32 else a, tree)


def jax_fixture(solver):
    import betty_tpu
    from betty_tpu import Config, Engine, EngineConfig, optim
    from betty_tpu.data import ArrayLoader
    from fixtures import Inner, Outer, child_module, parent_module

    (x, y), (xv, yv) = fixture_data()
    cfg = dict(SOLVERS[solver])
    inner_cls = Inner
    outer_cfg = Config()
    if solver == "itd":
        class ITDInner(betty_tpu.IterativeProblem):
            training_step = Inner.training_step
            on_inner_loop_start = Inner.on_inner_loop_start

        inner_cls, outer_cfg = ITDInner, Config(first_order=False)
    outer = Outer("outer", module=parent_module(), optimizer=optim.sgd(lr=1.0, momentum=0.9),
                  train_data_loader=ArrayLoader(xv, yv, batch_size=GLOBAL_BATCH, shuffle=False),
                  config=outer_cfg)
    inner = inner_cls("inner", module=child_module(),
                      optimizer=optim.adam(lr=0.05) if solver == "sama" else optim.sgd(lr=0.1),
                      train_data_loader=ArrayLoader(x, y, batch_size=GLOBAL_BATCH, shuffle=False),
                      config=Config(unroll_steps=UNROLL, **cfg))
    engine = Engine(config=EngineConfig(train_iters=ITERS), problems=[outer, inner],
                    dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}})
    engine.states = _f64_jax(engine.states)
    engine.run()
    return {n: np.asarray(engine.states[n]["params"]["w"]).tolist() for n in ("outer", "inner")}


def _jax_module(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def jax_bert_engine(batch):
    mod = _jax_module("bert_parallel_ref", os.path.join(
        os.path.dirname(HERE), "examples", "bert_data_reweighting", "main.py"))
    engine = mod.build_engine(mod.parse_args(BERT_ARGV + ["--batch_size", str(batch)]))
    engine.states = _f64_jax(engine.states)
    return engine


def jax_mwn_engine(batch):
    import torch_mwn_impl

    jmod = torch_mwn_impl.jax_example()
    engine = jmod.build_engine(jmod.parse_args(MWN_ARGV + ["--batch_size", str(batch)]))
    engine.states = _f64_jax(engine.states)
    torch_mwn_impl._f64_loaders(engine.problems)
    return engine


@contextlib.contextmanager
def world_of_one():
    """A gloo world of one over an in-process store for the scope (what a
    ``make_mesh`` without a process group joins; on the CPU over gloo),
    taken down after if the scope made it."""
    import torch.distributed as dist

    from betty_tpu_torch import parallel

    made = not dist.is_initialized()
    if made:
        parallel.maybe_init_distributed("cpu")
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def hand_over(path, tensors):
    """The JAX package's initial weights, in the port's layout, for the
    ranks (written whole, then renamed into place)."""
    import torch

    torch.save(tensors, path + ".tmp")
    os.replace(path + ".tmp", path)


def take_over(path, timeout=300.0):
    """The initial weights ``hand_over`` wrote, once they are there."""
    import torch

    start = time.time()
    while not os.path.exists(path):
        if time.time() - start > timeout:
            raise TimeoutError(f"no initial weights at {path} after {timeout} s")
        time.sleep(0.2)
    return torch.load(path, weights_only=True)


def _lists(tree):
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v).tolist()
            for k, v in tree.items()}


def run_ref(out, part):
    """One part of the references (``fixtures``, ``bert`` or ``mwn``), each
    in a process of its own: the JAX package keeps state across engines of
    one process, and the parts run side by side."""
    import jax
    import torch

    from betty_tpu_torch import convert

    jax.config.update("jax_enable_x64", True)
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if part == "fixtures":
        res = {f"fixture:{s}": jax_fixture(s) for s in SOLVERS}
    elif part == "bert":
        engine = jax_bert_engine(GLOBAL_BATCH // 4)
        hand_over(os.path.join(os.path.dirname(out), "init_bert.pt"), {
            "classifier": convert.from_flax_transformer(
                numpy(engine.states["classifier"]["params"]), dtype=torch.float64),
            "reweight": convert.from_flax_mwn(numpy(engine.states["reweight"]["params"]),
                                              dtype=torch.float64)})
        unshuffle(engine.problems)
        engine.run()
        res = {"bert": {
            "classifier": _lists(convert.from_flax_transformer(
                numpy(engine.states["classifier"]["params"]), dtype=torch.float64)),
            "reweight": _lists(convert.from_flax_mwn(numpy(engine.states["reweight"]["params"]),
                                                     dtype=torch.float64))}}
    else:
        import torch_mwn_impl

        engine = jax_mwn_engine(8)
        params, stats = torch_mwn_impl.resnet_state(engine.states["classifier"])
        hand_over(os.path.join(os.path.dirname(out), "init_mwn.pt"), {
            "classifier": params, "batch_stats": stats,
            "reweight": convert.from_flax_mwn(numpy(engine.states["reweight"]["params"]),
                                              dtype=torch.float64)})
        unshuffle(engine.problems)
        engine.run()
        params, stats = torch_mwn_impl.resnet_state(engine.states["classifier"])
        res = {"mwn": {"classifier": _lists(params), "batch_stats": _lists(stats),
                       "reweight": _lists(convert.from_flax_mwn(
                           numpy(engine.states["reweight"]["params"]), dtype=torch.float64))}}
    with open(out, "w") as f:
        json.dump(res, f)
    print("REF_OK", flush=True)


# ---------------------------------------------------------------------------
# the port, one rank
# ---------------------------------------------------------------------------


def port_fixture(solver, strategy, batch, iters=ITERS, config=None):
    import torch

    from betty_tpu_torch import Config, Engine, EngineConfig, IterativeProblem, optim
    from betty_tpu_torch.data import ArrayLoader
    from betty_tpu_torch.examples import logistic_regression_hpo as lr
    from betty_tpu_torch.module import from_fn

    (x, y), (xv, yv) = fixture_data()
    inner_cls, outer_cfg = lr.Inner, Config()
    if solver == "itd":
        class ITDInner(IterativeProblem):
            training_step = lr.Inner.training_step
            on_inner_loop_start = lr.Inner.on_inner_loop_start

        inner_cls, outer_cfg = ITDInner, Config(first_order=False)
    f64 = torch.float64
    outer = lr.Outer("outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20, dtype=f64)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9),
                     train_data_loader=ArrayLoader(xv, yv, batch_size=batch, shuffle=False),
                     config=outer_cfg)
    inner = inner_cls("inner",
                      module=from_fn(lambda p, i: (i @ p["w"], p["w"]),
                                     {"w": torch.zeros(20, dtype=f64)}),
                      optimizer=optim.adam(lr=0.05) if solver == "sama" else optim.sgd(lr=0.1),
                      train_data_loader=ArrayLoader(x, y, batch_size=batch, shuffle=False),
                      config=Config(unroll_steps=UNROLL, **SOLVERS[solver]))
    return Engine(config=config or EngineConfig(train_iters=iters, strategy=strategy),
                  problems=[outer, inner],
                  dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                  device="cpu")


def run_with_jax_directions(engine):
    """``engine.run()`` with reinforce drawing the JAX package's directions
    of each outer step."""
    import functools

    import jax
    import torch

    from betty_tpu_torch.hypergradient import jvp_fn_mapping, reinforce

    outer = engine.outer
    n = engine.inner.config.reinforce_samples

    def injected(_rng, i, like):
        key = jax.random.fold_in(jax.random.PRNGKey(outer._rng_seed), outer.count)
        u = jax_directions(key, n, {k: np.asarray(v) for k, v in like.items()})[i]
        return {k: torch.tensor(np.array(v)) for k, v in u.items()}

    saved = jvp_fn_mapping["reinforce"]
    jvp_fn_mapping["reinforce"] = functools.partial(reinforce, directions=injected)
    try:
        engine.run()
    finally:
        jvp_fn_mapping["reinforce"] = saved


def whole(engine):
    """Every problem's whole state (a collective under zero/fsdp)."""
    return {p.name: p.full_state() for p in engine.problems}


def leaves(tree, prefix=""):
    import torch

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree} if isinstance(tree, torch.Tensor) else {}


def max_err(a, b):
    import torch

    a, b = leaves(a), leaves(b)
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def bit_equal(a, b):
    import torch

    a, b = leaves(a), leaves(b)
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def shapes(engine):
    return {p.name: {k: list(v.shape) for k, v in leaves(
        {"params": engine.states[p.name]["params"],
         "opt_state": engine.states[p.name]["opt_state"]}).items()}
        for p in engine.problems}


def case_collectives(mesh):
    """The collectives against their definitions, on rank-dependent data."""
    import torch

    from betty_tpu_torch import parallel

    r, w = mesh.rank, mesh.world
    gen = torch.Generator().manual_seed(11)
    fulls = [torch.randn(w * 3, 5, generator=gen, dtype=torch.float64) for _ in range(w)]
    full = fulls[0]
    errs = {}
    shard = full.chunk(w, 0)[r].clone().requires_grad_(True)
    got = parallel.gather_shards({"a": shard}, {"a": 0}, mesh)["a"]
    errs["gather"] = float((got - full).abs().max())
    # backward of the gather: the sum over ranks of the cotangents, cut
    (g,) = torch.autograd.grad((got * fulls[r]).sum(), shard)
    errs["gather_backward"] = float((g - sum(fulls).chunk(w, 0)[r]).abs().max())
    # along dim 1: the gather's adjoint is the sum over ranks, cut on dim 1
    shard1 = full.t().chunk(w, 1)[r].clone().requires_grad_(True)
    got1 = parallel.gather_shards({"a": shard1}, {"a": 1}, mesh)["a"]
    (g1,) = torch.autograd.grad((got1 * fulls[r].t()).sum(), shard1)
    errs["reduce_scatter_dim1"] = float((g1 - sum(fulls).t().chunk(w, 1)[r]).abs().max())
    mean = parallel.reduce_scatter_mean({"a": fulls[r], "b": fulls[r][0]}, {"a": 0, "b": None},
                                        mesh)
    errs["reduce_scatter_mean"] = max(
        float((mean["a"] - (sum(fulls) / w).chunk(w, 0)[r]).abs().max()),
        float((mean["b"] - sum(fulls)[0] / w).abs().max()))
    # the differentiable all-reduce: reverse and forward mode of
    # f(x) = sum(global_sum(x * c_r)^3) against the global function
    c = torch.stack([f[0] for f in fulls])
    x = torch.linspace(0.1, 0.5, 5, dtype=torch.float64)
    with parallel.active(mesh):
        def f(x):
            return (parallel.global_sum(x * c[r]) ** 3).sum()

        g_local = torch.func.grad(f)(x)
        hv_local = torch.func.jvp(torch.func.grad(f), (x,), (torch.ones_like(x),))[1]
        g_mean = parallel.grad_mean(g_local)
        hv_mean = parallel.grad_mean(hv_local)

    def f_global(x):
        return ((x * c.sum(0)) ** 3).sum()

    errs["all_reduce_grad"] = float((g_mean - torch.func.grad(f_global)(x)).abs().max())
    errs["all_reduce_jvp"] = float((hv_mean - torch.func.jvp(
        torch.func.grad(f_global), (x,), (torch.ones_like(x),))[1]).abs().max())
    batch = parallel.make_global_batch((fulls[r][:2],), mesh)[0]
    errs["global_batch"] = float((batch - torch.cat([f[:2] for f in fulls])).abs().max())
    return max(errs.values()) <= 1e-12, errs


def case_batch_coupled(mesh):
    """The examples' other reductions over the batch, on this rank's rows
    ``rank::world`` of a global batch, against the one-process values on
    the whole batch: robust NAS's Jacobian, CURE and curvature terms and
    the IUC caption loss (value, and gradient in the parameters)."""
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import parallel
    from betty_tpu_torch.examples import robust_nas as rn
    from betty_tpu_torch.examples.nas_augmented_image_captioning_3_level import PAD, caption_loss

    torch.set_default_dtype(torch.float64)
    r, w = mesh.rank, mesh.world
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 2, 2, 3, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    net = rn.MixMLP(in_features=12, generator=torch.Generator().manual_seed(0))
    alphas = {"normal": torch.tensor([[0.3, -0.2]])}
    params = list(net.parameters())

    def regs(xb, yb):
        def loss_fn(xx):
            return F.cross_entropy(net(xx, alphas), yb)

        _, g = rn.input_grad(loss_fn, xb)
        terms = (rn.jacobian_reg(loss_fn, xb, 5, grad=g), rn.cure_reg(loss_fn, xb, grad=g),
                 rn.curvature_reg(loss_fn, xb, 7, iters=3))
        return terms, torch.autograd.grad(sum(terms), params)

    want, want_g = regs(x, y)
    with parallel.active(mesh):
        got, got_g = regs(x[r::w], y[r::w])
        got = parallel.grad_mean([t.detach() for t in got])
        got_g = parallel.grad_mean(list(got_g))
    errs = {name: float((a - b.detach()).abs().max())
            for name, a, b in zip(("jacobian", "cure", "curvature"), got, want)}
    errs["robust_grad"] = max(float((a - b).abs().max()) for a, b in zip(got_g, want_g))
    # IUC: a token loss over a global count of unpadded targets
    proj = torch.randn(6, 11, generator=gen, requires_grad=True)
    feats = torch.randn(8, 5, 6, generator=gen)
    targets = torch.randint(0, 11, (8, 5), generator=gen)
    targets[:, 3:] = PAD
    targets[1, 1:] = PAD
    want = caption_loss(feats @ proj, targets)
    (want_g,) = torch.autograd.grad(want, proj)
    with parallel.active(mesh):
        got = caption_loss(feats[r::w] @ proj, targets[r::w])
        (got_g,) = torch.autograd.grad(got, proj)
        got, got_g = parallel.grad_mean((got.detach(), got_g))
    errs["caption"] = float((got - want).abs())
    errs["caption_grad"] = float((got_g - want_g).abs().max())
    torch.set_default_dtype(torch.float32)
    return max(errs.values()) <= 1e-12, errs


def case_bert_dropout(global_batch, world):
    """The small bert program at dropout 0.1 under dp against one process
    on the global batch (the port both sides; float64): each rank draws
    its rows of the global batch's dropout masks."""
    import torch

    from betty_tpu_torch.examples import bert_data_reweighting as tex
    from betty_tpu_torch.utils import tree_map

    argv = BERT_ARGV + ["--dropout", "0.1", "--device", "cpu"]
    out = {}
    for strategy, batch in (("default", global_batch), ("dp", global_batch // world)):
        engine = tex.build_engine(tex.parse_args(argv + ["--batch_size", str(batch),
                                                         "--strategy", strategy]))
        engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                                 and t.is_floating_point() else t, engine.states)
        unshuffle(engine.problems)
        engine.run()
        out[strategy] = {n: s["params"] for n, s in engine.states.items()}
    err = max_err(out["dp"], out["default"])
    return err <= 1e-10, {"max_abs_err": err}


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import EngineConfig, parallel
    from betty_tpu_torch.parallel import mesh as mesh_mod

    parallel.maybe_init_distributed("cpu", timeout=300)
    world = torch.distributed.get_world_size()
    batch = GLOBAL_BATCH // world
    res = {}

    t0 = time.time()

    def record(name, ok, info):
        res[name] = {"ok": bool(ok), "info": info, "seconds": round(time.time() - t0, 2)}

    if group == "two":
        import jax

        jax.config.update("jax_enable_x64", True)
        mesh = parallel.make_mesh()
        record("collectives", *case_collectives(mesh))
        dp = {}
        for solver in SOLVERS:
            engine = port_fixture(solver, "dp", batch)
            (run_with_jax_directions if solver == "reinforce" else type(engine).run)(engine)
            dp[solver] = whole(engine)
            res[f"dp:{solver}"] = {n: dp[solver][n]["params"]["w"].tolist()
                                   for n in ("outer", "inner")}
        # every leaf of the fixtures program sharded
        mesh_mod.FSDP_MIN_SIZE = 1
        for strategy in ("zero", "fsdp"):
            for solver in SOLVERS:
                engine = port_fixture(solver, strategy, batch)
                (run_with_jax_directions if solver == "reinforce" else type(engine).run)(engine)
                got = whole(engine)
                record(f"{strategy}:{solver}", bit_equal(
                    {n: got[n]["params"] for n in got}, {n: dp[solver][n]["params"] for n in got}),
                    {"max_abs_err": max_err({n: got[n]["params"] for n in got},
                                            {n: dp[solver][n]["params"] for n in got}),
                     "shapes": shapes(engine)})
        # an fsdp run cut after 3 steps (mid-unroll) and auto-resumed
        cut = os.path.join(work_dir, "fsdp_checkpoint")
        straight = port_fixture("sama", "fsdp", batch)
        straight.run()
        port_fixture("sama", "fsdp", batch, config=EngineConfig(
            train_iters=3, strategy="fsdp", checkpoint_step=3, checkpoint_dir=cut)).run()
        resumed = port_fixture("sama", "fsdp", batch, config=EngineConfig(
            train_iters=ITERS, strategy="fsdp", checkpoint_dir=cut, auto_resume=True))
        resumed.run()
        a, b = whole(straight), whole(resumed)
        record("fsdp_resume", bit_equal(a, b) and resumed.global_step == ITERS,
               {"max_abs_err": max_err(a, b), "global_step": resumed.global_step,
                "shapes": shapes(resumed)})
        # compiled blocks under fsdp (the host-staging data path) against
        # driver mode
        runs = {}
        for compiled in (False, True):
            engine = port_fixture("sama", "fsdp", batch, config=EngineConfig(
                train_iters=12, strategy="fsdp", compile_blocks=compiled))
            engine.run()
            runs[compiled] = whole(engine)
        runner = engine.block_runner
        record("fsdp_compiled", bit_equal(runs[True], runs[False]) and runner.periods_run > 0
               and not runner.fastpath,
               {"max_abs_err": max_err(runs[True], runs[False]),
                "periods": runner.periods_run})
        mesh_mod.FSDP_MIN_SIZE = 2**14
    elif group == "models":
        mesh = parallel.make_mesh()
        record("batch_coupled", *case_batch_coupled(mesh))
        record("bert_dropout", *case_bert_dropout(GLOBAL_BATCH // 4, world))
        res["mlp"] = tutorial_runs(batch, ("dp", "zero", "fsdp"))
        res["bert"] = port_bert(GLOBAL_BATCH // 4 // world, work_dir)
        res["mwn"] = port_mwn(8 // world, work_dir)
    else:
        mesh_mod.FSDP_MIN_SIZE = 1
        for solver in ("darts", "sama"):
            runs = {}
            for strategy in ("dp", "fsdp"):
                engine = port_fixture(solver, strategy, batch)
                engine.run()
                runs[strategy] = whole(engine)
            p = {s: {n: r[n]["params"] for n in r} for s, r in runs.items()}
            record(f"fsdp4:{solver}", max_err(p["fsdp"], p["dp"]) <= 1e-12,
                   {"max_abs_err": max_err(p["fsdp"], p["dp"])})
            # a dcn x dp mesh: shards over dp (2), replicated across dcn (2)
            engine = port_fixture(solver, "fsdp", batch, config=EngineConfig(
                train_iters=ITERS, strategy="fsdp", mesh_shape=(("dcn", 2), ("dp", 2))))
            engine.run()
            got = {n: r["params"] for n, r in whole(engine).items()}
            record(f"dcn:{solver}", max_err(got, p["dp"]) <= 1e-12,
                   {"max_abs_err": max_err(got, p["dp"]), "shapes": shapes(engine)})
        mesh_mod.FSDP_MIN_SIZE = 2**14
        res["mlp"] = tutorial_runs(batch, ("dp", "fsdp"))
    if torch.distributed.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", torch.distributed.get_rank(), flush=True)


def tutorial_runs(batch, strategies):
    """Tutorial 5's program (a 784x128 MLP classifier under a reweighter)
    for 6 steps under each strategy, float64: the whole parameters of each
    and the shapes this rank holds."""
    import importlib

    import torch

    from betty_tpu_torch.utils import tree_map

    t5 = importlib.import_module("betty_tpu_torch.tutorial.5_distributed_training")
    out = {}
    for strategy in strategies:
        args = t5.parse_args(["--device", "cpu", "--strategy", strategy, "--train_iters", "6",
                              "--batch_size", str(batch), "--no_shuffle"])
        engine = t5.build_engine(args)
        engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                                 and t.is_floating_point() else t, engine.states)
        for p in engine.problems:
            for dl in p.train_data_loader:
                dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])
        engine.run()
        full = whole(engine)
        out[strategy] = {"params": {n: {k: v.tolist() for k, v in leaves(s["params"]).items()}
                                    for n, s in full.items()},
                         "shapes": shapes(engine)}
    return out


def port_bert(batch, init_dir):
    """The small bert_data_reweighting program under dp from the JAX
    package's initial weights."""
    import torch

    from betty_tpu_torch.examples import bert_data_reweighting as tex
    from betty_tpu_torch.utils import tree_map

    init = take_over(os.path.join(init_dir, "init_bert.pt"))
    engine = tex.build_engine(tex.parse_args(BERT_ARGV + ["--batch_size", str(batch),
                                                          "--device", "cpu", "--strategy", "dp"]))
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                             and t.is_floating_point() else t, engine.states)
    for name in ("classifier", "reweight"):
        engine.states[name]["params"] = init[name]
    unshuffle(engine.problems)
    engine.run()
    return {n: _lists(engine.states[n]["params"]) for n in ("classifier", "reweight")}


def port_mwn(batch, init_dir):
    """The small MWN program (3-block ResNet, darts) under dp from the JAX
    package's initial weights."""
    import torch

    from betty_tpu_torch.examples import learning_to_reweight as tex
    from betty_tpu_torch.utils import tree_map

    init = take_over(os.path.join(init_dir, "init_mwn.pt"))
    engine = tex.build_engine(tex.parse_args(MWN_ARGV + [
        "--batch_size", str(batch), "--device", "cpu", "--stage_sizes", "1,1,1",
        "--strategy", "dp"]))
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t)
                             and t.is_floating_point() else t, engine.states)
    for p in engine.problems:
        for dl in p.train_data_loader:
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])
    engine.states["classifier"]["params"] = init["classifier"]
    engine.states["classifier"]["extra"] = {"batch_stats": init["batch_stats"]}
    engine.states["reweight"]["params"] = init["reweight"]
    unshuffle(engine.problems)
    engine.run()
    st = engine.states["classifier"]
    return {"classifier": _lists(st["params"]), "batch_stats": _lists(st["extra"]["batch_stats"]),
            "reweight": _lists(engine.states["reweight"]["params"])}


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_ref(sys.argv[2], sys.argv[3])
    else:
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
