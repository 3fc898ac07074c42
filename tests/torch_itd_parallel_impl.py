"""ITD replays (``IterativeProblem`` under a ``Config(first_order=False)``
parent) under model parallelism, on the CPU over gloo, in float64, against
the JAX package's sequential, unsharded ITD runs and the port's own
one-process runs. Run by test_torch_itd_parallel.py.

Each program is the one its model-parallel test already holds, made ITD:
the child an ``IterativeProblem`` carrying the program's own
``training_step`` with SGD, the parent ``first_order=False``, unroll 2
(``itd_engine``, on both sides):

* ``flat``: tutorial 7's tp program at small width (``TransformerClassifier``
  at ``FLAT``, dropout 0, reweighted by a Meta-Weight-Net), on
  ``dp:1,mdl:2`` and ``dp:2,mdl:2`` under ``strategy="tp"``; ``flat_gas``
  the same with gradient accumulation 2, clipping and a ``grad_callback``;
* ``pipe``: tests/torch_pp_impl.py's program (``make_pipelined_transformer``
  at tests/test_composed.py's CFG), on ``dp:1,pp:2`` (M 2, ``"pp"``),
  ``dp:1,sp:2`` (``"sp"``), ``dp:1,mdl:2,pp:2`` and ``dp:1,mdl:2,sp:2``
  (``"tp"`` with ``models.pipelined_shard_rules``);
* ``moe``: tests/test_ep.py's MoE program (tests/torch_tp_impl.py's
  ``moe_engine``), on ``dp:1,ep:2`` (``"ep"``) and ``dp:1,ep:2,mdl:2``
  (``"tp"`` with ``MOE_COMPOSED_SHARD_RULES``);
* ``maml``: ``flat``'s classifier under a meta problem that holds its
  initial parameters whole, the unroll starting from them (``unroll_init``),
  on ``dp:1,mdl:2``.

    python tests/torch_itd_parallel_impl.py ref OUT.json FAMILY
        The JAX package's ITD run of FAMILY (``flat``, ``flat_gas``,
        ``pipe``, ``moe``, ``maml``), one process, x64; all but
        ``flat_gas`` hand their initial weights over in OUT's directory.

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_itd_parallel_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port; GROUP runs the meshes of ``GROUP_MESHES`` in
        turn (each engine makes its own groups). On each mesh the ITD run
        against the port's one-process run, with the collective calls
        counted by phase (the child's eager steps, the parent's replays);
        on ``dp:1,mdl:2`` also ``flat_gas``, ``maml``, compiled blocks
        against driver mode and a run cut mid-unroll and auto-resumed; on
        ``dp:1,mdl:2,pp:2`` compiled blocks. Rank 0 writes the results.
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

ITERS, UNROLL = 4, 2
FLAT = dict(vocab_size=64, max_len=8, dim=16, depth=2, heads=2, num_classes=2)
GAS, CLIP = 2, 0.05
# mesh -> (family, strategy, microbatches)
MESHES = {"dp:1,mdl:2": ("flat", "tp", None), "dp:2,mdl:2": ("flat", "tp", None),
          "dp:1,ep:2": ("moe", "ep", None), "dp:1,ep:2,mdl:2": ("moe", "tp", None),
          "dp:1,pp:2": ("pipe", "pp", 2), "dp:1,sp:2": ("pipe", "sp", None),
          "dp:1,mdl:2,pp:2": ("pipe", "tp", 2), "dp:1,mdl:2,sp:2": ("pipe", "tp", None)}
GROUP_MESHES = {"mdl2": ("dp:1,mdl:2",), "two": ("dp:1,ep:2", "dp:1,pp:2", "dp:1,sp:2"),
                "four_tp": ("dp:2,mdl:2", "dp:1,ep:2,mdl:2"),
                "four_pp": ("dp:1,mdl:2,pp:2", "dp:1,mdl:2,sp:2")}
WORLDS = {"mdl2": 2, "two": 2, "four_tp": 4, "four_pp": 4}
COMPILED = ("dp:1,mdl:2", "dp:1,mdl:2,pp:2")
FAMILIES = ("flat", "flat_gas", "pipe", "moe", "maml")
# the MAML case's meta-parameters held whole under tp (no rule cuts them)
WHOLE_RULES = ((r".*", ()),)
CHILD = {"flat": "classifier", "pipe": "classifier", "moe": "inner"}
PARENT = {"flat": "reweight", "pipe": "reweight", "moe": "outer"}


def hooks(pkg):
    """``flat_gas``'s ``grad_callback`` on the package ``pkg``: the running
    sum divided by one plus its squared norm (a function of every leaf,
    whole)."""
    if pkg.__name__ == "betty_tpu":
        import jax
        import jax.numpy as jnp

        leaves, tmap, total = jax.tree_util.tree_leaves, jax.tree_util.tree_map, jnp.sum
    else:
        import torch

        from betty_tpu_torch.utils import tree_leaves as leaves, tree_map as tmap

        total = torch.sum

    def grad_callback(self):
        g = self.grads
        n = sum(total(t * t) for t in leaves(g))
        self.set_grads_value(tmap(lambda t: t / (1.0 + n), g))

    return {"grad_callback": grad_callback}


def itd_engine(pkg, base, family, gas=False, iters=ITERS, **engine_kw):
    """``base`` (a two-problem engine of ``family``, its states set) rebuilt
    through ``pkg``'s public API (``betty_tpu`` or ``betty_tpu_torch``) as
    ITD: the child an ``IterativeProblem`` with the base child's
    ``training_step``, module, optimizer (SGD) and loader, unroll 2, the
    parent ``first_order=False``; ``gas``: ``flat_gas``'s accumulation,
    clipping and hook. The base's states are kept."""
    import dataclasses

    problems = {p.name: p for p in base.problems}
    child, parent = problems[CHILD[family]], problems[PARENT[family]]
    body = {"training_step": type(child).training_step, **(hooks(pkg) if gas else {})}
    cls = type(f"ITD{type(child).__name__}", (pkg.IterativeProblem,), body)
    ccfg = dataclasses.replace(child.config, unroll_steps=UNROLL, **(
        dict(gradient_accumulation=GAS, gradient_clipping=CLIP) if gas else {}))
    c = cls(child.name, module=child.module_fn, optimizer=child.optimizer,
            train_data_loader=child.train_data_loader[0], config=ccfg)
    p = type(parent)(parent.name, module=parent.module_fn, optimizer=parent.optimizer,
                     train_data_loader=parent.train_data_loader[0],
                     config=dataclasses.replace(parent.config, first_order=False))
    engine = pkg.Engine(config=dataclasses.replace(base.config, train_iters=iters, **engine_kw),
                        problems=[p, c], dependencies={"u2l": {p: [c]}, "l2u": {c: [p]}},
                        **({} if pkg.__name__ == "betty_tpu" else {"device": "cpu"}))
    engine.states = base.states
    return engine


# ---------------------------------------------------------------------------
# the JAX package's references
# ---------------------------------------------------------------------------


def jax_family(family):
    """The JAX package's ITD engine of ``family`` (float64) and the
    function that puts its states in the port's layout."""
    import betty_tpu
    import jax
    import torch

    from betty_tpu_torch import convert

    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if family == "moe":
        import torch_moe_impl

        return (itd_engine(betty_tpu, torch_moe_impl.jax_program(), "moe"),
                torch_moe_impl.port_params)
    if family == "maml":
        def port(states):
            return {n: convert.from_flax_transformer(numpy(states[n]["params"]),
                                                     dtype=torch.float64)
                    for n in ("classifier", "meta")}

        return jax_maml(), port
    if family == "pipe":
        base, _ = ppi.jax_engine("darts")
        clf = convert.from_jax_pipelined
    else:
        import jax.numpy as jnp

        from betty_tpu.models import TransformerClassifier
        from betty_tpu.module import from_flax

        module = from_flax(TransformerClassifier(**FLAT, dropout=0.0),
                           jnp.zeros((64, FLAT["max_len"]), jnp.int32),
                           rng=jax.random.PRNGKey(0), train_kwarg="train")
        base, _ = ppi.jax_engine("darts", module=module)
        clf = convert.from_flax_transformer
    gas = family == "flat_gas"

    def port(states):
        return {"classifier": clf(numpy(states["classifier"]["params"]), dtype=torch.float64),
                "reweight": convert.from_flax_mwn(numpy(states["reweight"]["params"]),
                                                  dtype=torch.float64)}

    return itd_engine(betty_tpu, base, "flat", gas=gas, iters=2 * ITERS if gas else ITERS), port


def jax_maml():
    """The MAML variant of ``flat`` in the JAX package: the meta problem
    holds the classifier's initial parameters (``from_fn``), the classifier
    (ITD, SGD, unroll 2) starts each unroll from them (``on_inner_loop_start``
    and ``unroll_init``) and the meta loss is its cross entropy on the
    second batch, ``first_order=False``."""
    import jax
    import jax.numpy as jnp
    import optax

    from betty_tpu import Config, Engine, EngineConfig, ImplicitProblem, IterativeProblem, optim
    from betty_tpu.models import TransformerClassifier
    from betty_tpu.module import from_fn, from_flax

    def ce(logits, y):
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    class Meta(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            return ce(self.classifier(ids), y)

    class Adapt(IterativeProblem):
        def training_step(self, batch):
            ids, y = batch
            return ce(self.module(ids), y)

        def on_inner_loop_start(self):
            self.set_params(self.meta.params)

        def unroll_init(self, start_params):
            return self.meta.params

    (ids, y), (mids, my) = ppi.data(64, 0), ppi.data(32, 1)
    module = from_flax(TransformerClassifier(**FLAT, dropout=0.0),
                       jnp.zeros((64, FLAT["max_len"]), jnp.int32), rng=jax.random.PRNGKey(0),
                       train_kwarg="train")
    theta = tpi._f64_jax(module.init(jax.random.PRNGKey(0))["params"])
    adapt = Adapt("classifier", module=module, optimizer=optim.sgd(lr=0.05),
                  train_data_loader=[(jnp.asarray(ids), jnp.asarray(y))],
                  config=Config(unroll_steps=UNROLL))
    meta = Meta("meta", module=from_fn(lambda p: p, theta), optimizer=optim.sgd(lr=0.05),
                train_data_loader=[(jnp.asarray(mids), jnp.asarray(my))],
                config=Config(first_order=False))
    engine = Engine(config=EngineConfig(train_iters=ITERS), problems=[meta, adapt],
                    dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}})
    engine.states = tpi._f64_jax(engine.states)
    return engine


def run_ref(out, family):
    import jax

    jax.config.update("jax_enable_x64", True)
    engine, port = jax_family(family)
    init = port(engine.states)
    if family != "flat_gas":
        tpi.hand_over(os.path.join(os.path.dirname(out), f"init_{family}.pt"), init)
    engine.run()
    with open(out, "w") as f:
        json.dump({"final": {n: _lists(t) for n, t in port(engine.states).items()},
                   "init": {n: _lists(t) for n, t in init.items()}}, f)
    print("REF_OK", flush=True)


def _lists(tree):
    return {k: v.tolist() for k, v in tpi.leaves(tree).items()}


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def flat_base(strategy, mesh_spec, init, **engine_kw):
    """tests/torch_pp_impl.py's program with tutorial 7's tp classifier
    (``TransformerClassifier`` at FLAT, dropout 0, the Megatron layouts
    under ``"tp"``), float64, from the JAX package's weights; each batch
    rank loads its rows ``index::count``."""
    from betty_tpu_torch import Config, Engine, EngineConfig, optim, parallel
    from betty_tpu_torch.data.loader import ArrayLoader
    from betty_tpu_torch.models import MetaWeightNet, TransformerClassifier
    from betty_tpu_torch.module import from_torch

    Reweight, Classifier = ppi._classes()
    shape = parallel.mesh_shape(mesh_spec)
    index, count = parallel.batch_coordinates(shape) if mesh_spec else (0, 1)
    rows = slice(index, None, count)

    def loader(n, seed):
        # an ArrayLoader (one unshuffled batch an epoch): a run resumes
        # mid-unroll only on loaders that can restart at a batch
        ids, y = ppi.data(n, seed)
        return ArrayLoader(ids[rows], y[rows], batch_size=n // count, shuffle=False)

    clf = Classifier("classifier", module=from_torch(TransformerClassifier(**FLAT, dropout=0.0)),
                     optimizer=optim.sgd(lr=0.05), train_data_loader=loader(64, 0),
                     config=Config(unroll_steps=UNROLL))
    rw = Reweight("reweight", module=from_torch(MetaWeightNet()), optimizer=optim.adam(lr=1e-3),
                  train_data_loader=loader(32, 1), config=Config())
    engine = Engine(config=EngineConfig(train_iters=ITERS, strategy=strategy, mesh_shape=shape,
                                        autoshard_data=False, **engine_kw),
                    problems=[rw, clf],
                    dependencies={"u2l": {rw: [clf]}, "l2u": {clf: [rw]}}, device="cpu")
    _set_states(engine, init)
    return engine


def maml_engine(strategy, mesh_spec, init):
    """``jax_maml``'s program on the port (float64, from the JAX package's
    weights): under ``"tp"`` the classifier's leaves are cut by the
    Megatron rules and the meta-parameters are held whole
    (``WHOLE_RULES``), so the replay's ``unroll_init`` cuts them to the
    classifier's shards."""
    import torch
    import torch.nn.functional as F

    from betty_tpu_torch import (Config, Engine, EngineConfig, ImplicitProblem,
                                 IterativeProblem, optim, parallel)
    from betty_tpu_torch.models import TransformerClassifier
    from betty_tpu_torch.module import from_fn, from_torch

    class Meta(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            return F.cross_entropy(self.classifier(ids), y.long())

    class Adapt(IterativeProblem):
        def training_step(self, batch):
            ids, y = batch
            return F.cross_entropy(self.module(ids), y.long())

        def on_inner_loop_start(self):
            self.set_params(self.meta.params)

        def unroll_init(self, start_params):
            return self.meta.params

    shape = parallel.mesh_shape(mesh_spec)
    index, count = parallel.batch_coordinates(shape) if mesh_spec else (0, 1)
    rows = slice(index, None, count)
    (ids, y), (mids, my) = ppi.data(64, 0), ppi.data(32, 1)
    adapt = Adapt("classifier", module=from_torch(TransformerClassifier(**FLAT, dropout=0.0)),
                  optimizer=optim.sgd(lr=0.05),
                  train_data_loader=[(torch.tensor(ids[rows]), torch.tensor(y[rows]))],
                  config=Config(unroll_steps=UNROLL))
    meta = Meta("meta", module=from_fn(lambda p: p, dict(init["meta"])),
                optimizer=optim.sgd(lr=0.05),
                train_data_loader=[(torch.tensor(mids[rows]), torch.tensor(my[rows]))],
                config=Config(first_order=False, shard_rules=WHOLE_RULES))
    engine = Engine(config=EngineConfig(train_iters=ITERS, strategy=strategy, mesh_shape=shape,
                                        autoshard_data=False),
                    problems=[meta, adapt],
                    dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}}, device="cpu")
    _set_states(engine, init)
    return engine


def case_maml(mesh_spec, init, res, rank):
    """The MAML program on ``mesh_spec`` against the one-process run: the
    meta-parameters whole, the classifier's shards cut from them."""
    want = None
    if rank == 0:
        ref = maml_engine("default", None, init)
        ref.run()
        want = ppi.whole_params(ref)
    engine = maml_engine("tp", mesh_spec, init)
    engine.run()
    held = {n: sum(x.numel() for x in tpi.leaves(engine.states[n]["params"]).values())
            for n in ("classifier", "meta")}
    _compare(res, "maml", rank, ppi.whole_params(engine), want, held=held)


def _set_states(engine, init):
    import torch

    from betty_tpu_torch.utils import tree_map

    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    for p in engine.problems:
        st = dict(engine.states[p.name])
        st["params"] = p.shard_full_state({"params": tree_map(torch.clone, init[p.name])})[
            "params"]
        engine.states[p.name] = st


def port_itd(family, mesh_spec, init, gas=False, iters=None, **engine_kw):
    """The port's ITD engine of ``family`` on ``mesh_spec`` under its
    strategy of ``MESHES`` (None: one process)."""
    import betty_tpu_torch
    import torch_tp_impl as tti

    strategy, M = MESHES[mesh_spec][1:] if mesh_spec else ("default", None)
    if family == "flat":
        base = flat_base(strategy, mesh_spec, init)
    elif family == "moe":
        base = tti.moe_engine(strategy, mesh_spec, init)
    else:
        rules = None
        if strategy == "tp":
            from betty_tpu_torch import parallel
            from betty_tpu_torch.models import pipelined_shard_rules

            rules = pipelined_shard_rules(parallel.mesh_shape(mesh_spec))
        base = ppi.port_engine("darts", strategy, mesh_spec, init, M,
                               sp=bool(mesh_spec) and "sp" in mesh_spec, rules=rules)
    iters = iters or (2 * ITERS if gas else ITERS)
    return itd_engine(betty_tpu_torch, base, family, gas=gas, iters=iters, **engine_kw)


class Calls:
    """The collective calls of a run by phase: ``child`` (the child's eager
    steps), ``replay`` (the parent's replays of the child's unroll, their
    forward) and ``parent`` (the rest of the parent's steps, the backward
    through the replays included), each by ``op:group`` (the mesh's axis
    names, ``model``, ``batch``); and the element count of the parameters
    the child's optimizer stepped in a replay."""

    OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
           "batch_isend_irecv")

    def __init__(self, engine, family):
        import torch.distributed as dist

        self.counts = {"child": {}, "replay": {}, "parent": {}}
        self.stepped = []
        self.phase = []
        self.replays = self.child_steps = 0
        mesh = engine.mesh
        labels = {id(g): a for a, g in mesh.axis_groups.items()}
        labels.setdefault(id(mesh.model_group), "model")
        labels[id(mesh.batch_group)] = "batch"
        self._saved = {}
        for op in self.OPS:
            orig = self._saved[op] = getattr(dist, op)

            def wrapped(*a, _orig=orig, _op=op, **kw):
                if self.phase:
                    group = kw.get("group")
                    if _op == "all_reduce" and group is None and len(a) > 2:
                        group = a[2]
                    if _op == "batch_isend_irecv":
                        group = a[0][0].group
                    key = f"{_op}:{labels.get(id(group), 'other')}"
                    bucket = self.counts[self.phase[-1]]
                    bucket[key] = bucket.get(key, 0) + 1
                return _orig(*a, **kw)

            setattr(dist, op, wrapped)
        child = engine.problems[[p.name for p in engine.problems].index(CHILD[family])]
        parent = next(p for p in engine.problems if p is not child)
        self._wrap(child, "one_step_descent", "child")
        self._wrap(parent, "one_step_descent", "parent")
        self._wrap(child, "replay_unroll", "replay")
        update = child.optimizer.update

        def stepped(grads, opt_state, params, **kw):
            if self.phase and self.phase[-1] == "replay":
                self.stepped.append(sum(x.numel() for x in tpi.leaves(params).values()))
            return update(grads, opt_state, params, **kw)

        child.optimizer.update = stepped

    def _wrap(self, problem, name, phase):
        fn = getattr(problem, name)

        def wrapped(*a, **kw):
            self.phase.append(phase)
            if phase == "replay":
                self.replays += 1
            elif phase == "child":
                self.child_steps += 1
            try:
                return fn(*a, **kw)
            finally:
                self.phase.pop()

        setattr(problem, name, wrapped)

    def restore(self):
        import torch.distributed as dist

        for op, fn in self._saved.items():
            setattr(dist, op, fn)

    def info(self, engine, family):
        child = next(p for p in engine.problems if p.name == CHILD[family])
        held = sum(x.numel() for x in tpi.leaves(engine.states[child.name]["params"]).values())
        return {"counts": self.counts, "replays": self.replays, "child_steps": self.child_steps,
                "micro_steps": UNROLL * child.gas, "stepped": self.stepped, "held": held,
                "whole": sum(x.numel() for x in tpi.leaves(child.full_state()["params"]).values())}


def _one_process(rank, family, init, **kw):
    """The port's one-process ITD run's whole parameters on rank 0."""
    if rank != 0:
        return None
    ref = port_itd(family, None, init, **kw)
    ref.run()
    return ppi.whole_params(ref)


def _compare(res, key, rank, got, want, **info):
    if rank == 0:
        err = tpi.max_err(got, want)
        res[key] = {"ok": err <= 1e-12, "info": {"max_abs_err": err, **info},
                    "params": {n: _lists(t) for n, t in got.items()}}


def case_mesh(mesh_spec, init, res, rank):
    """The ITD run on ``mesh_spec`` against the one-process run (and, in
    the test, JAX's), with its collective calls by phase."""
    family = MESHES[mesh_spec][0]
    want = _one_process(rank, family, init)
    engine = port_itd(family, mesh_spec, init)
    calls = Calls(engine, family)
    try:
        engine.run()
    finally:
        calls.restore()
    _compare(res, mesh_spec, rank, ppi.whole_params(engine), want,
             calls=calls.info(engine, family), strategy=engine.strategy)


def case_gas(mesh_spec, init, res, rank):
    """``flat_gas`` (accumulation 2, clipping, ``grad_callback``) on
    ``mesh_spec``; on rank 0 also how far the one-process run lands from
    the same run unclipped (the clipping is active)."""
    want = _one_process(rank, "flat", init, gas=True)
    clip_effect = None
    if rank == 0:
        unclipped = port_itd("flat", None, init, gas=True)
        unclipped.classifier.gradient_clipping = 0.0
        unclipped.run()
        clip_effect = tpi.max_err(ppi.whole_params(unclipped), want)
    engine = port_itd("flat", mesh_spec, init, gas=True)
    engine.run()
    _compare(res, "flat_gas", rank, ppi.whole_params(engine), want, clip_effect=clip_effect)


def case_compiled(mesh_spec, init, res):
    """Compiled blocks against driver mode, 8 iterations."""
    runs, runner = {}, None
    for compiled in (False, True):
        engine = port_itd(MESHES[mesh_spec][0], mesh_spec, init, iters=2 * ITERS,
                          compile_blocks=compiled)
        engine.run()
        runs[compiled] = ppi.whole_params(engine)
        runner = engine.block_runner
    res[f"compiled:{mesh_spec}"] = {
        "ok": tpi.bit_equal(runs[True], runs[False]) and runner is not None
        and runner.periods_run > 0,
        "info": {"max_abs_err": tpi.max_err(runs[True], runs[False]),
                 "periods": getattr(runner, "periods_run", 0)}}


def case_resume(mesh_spec, init, work_dir, res):
    """A run cut after 3 steps (mid-unroll: the checkpoint keeps the
    recorded start state and batch) and auto-resumed, against the
    uninterrupted run."""
    import torch

    cut = os.path.join(work_dir, "itd_checkpoint")
    straight = port_itd("flat", mesh_spec, init)
    straight.run()
    first = port_itd("flat", mesh_spec, init, checkpoint_step=3, checkpoint_dir=cut)
    first.train_iters = 3
    first.run()
    resumed = port_itd("flat", mesh_spec, init, checkpoint_dir=cut, auto_resume=True)
    resumed.run()
    a, b = ppi.whole_params(straight), ppi.whole_params(resumed)
    saved = torch.load(os.path.join(cut, "step_3.pt"), weights_only=True)
    start = saved["__unroll_start__classifier"]["params"]["blocks.0.attn.query.kernel"]
    res["resume"] = {"ok": tpi.bit_equal(a, b) and resumed.global_step == ITERS,
                     "info": {"max_abs_err": tpi.max_err(a, b),
                              "global_step": resumed.global_step,
                              "saved_start_query_kernel": list(start.shape),
                              "recorded": len(saved["__unroll_batches__classifier"])}}


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=300)
    rank = torch.distributed.get_rank()
    inits = {}
    res = {}
    t0 = time.time()
    for mesh_spec in GROUP_MESHES[group]:
        family = MESHES[mesh_spec][0]
        if family not in inits:
            inits[family] = tpi.take_over(os.path.join(work_dir, f"init_{family}.pt"))
        init = inits[family]
        case_mesh(mesh_spec, init, res, rank)
        if mesh_spec == "dp:1,mdl:2":
            case_gas(mesh_spec, init, res, rank)
            case_resume(mesh_spec, init, work_dir, res)
            case_maml(mesh_spec, tpi.take_over(os.path.join(work_dir, "init_maml.pt")), res,
                      rank)
        if mesh_spec in COMPILED:
            case_compiled(mesh_spec, init, res)
        res[f"seconds:{mesh_spec}"] = round(time.time() - t0, 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


TIMEOUT = 300


def launch(work):
    """The JAX references and every group's ranks side by side
    (torchrun's variables, gloo, one thread a process); waits for all of
    them (a failure or a timeout raises) and loads their JSON results."""
    import subprocess

    from test_torch_parallel import _env, _free_port

    procs = []
    for family in FAMILIES:
        procs.append((f"ref_{family}", subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "ref",
             os.path.join(work, f"ref_{family}.json"), family],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for group, world in WORLDS.items():
        port = _free_port()
        for rank in range(world):
            env = _env(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append((f"{group} rank {rank}", subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "rank",
                 os.path.join(work, f"{group}.json"), work, group], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
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
    for name in [f"ref_{f}" for f in FAMILIES] + list(WORLDS):
        with open(os.path.join(work, f"{name}.json")) as fh:
            out[name] = json.load(fh)
    return out


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_ref(sys.argv[2], sys.argv[3])
    else:
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
