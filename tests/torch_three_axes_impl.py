"""Meshes with three and four model axes, on the CPU over gloo, in float64,
against the JAX package's sequential (unsharded) runs and the port's own
one-process runs. Run by test_torch_three_axes.py, test_torch_three_axes_moe.py
and test_torch_four_axes.py.

A module computes on the axes it splits, and the ranks of every other
model axis repeat its work on the same batch, so each mesh's run equals
the unsharded program: the JAX references are the JAX package's sequential
runs (``torch_pp_impl.py``'s ``ref`` cases, ``torch_tp_impl.py``'s
``ref_moe``, ``torch_itd_parallel_impl.py``'s ITD ``ref`` cases), plus two
of this file:

    python tests/torch_three_axes_impl.py ref_t7 OUT.json
        The JAX tutorial 7's pp program (tutorial/7_model_parallelism.py:
        the Meta-Weight-Net reweighting darts, unroll 1, AdamW 1e-4 and
        Adam 1e-4, batches of ``RandomState(seed)``) at ``T7`` widths on
        the sequential ``make_pipelined_transformer``, x64, ``T7_ITERS``
        steps; hands its initial weights over as ``init_t7.pt``.

    python tests/torch_three_axes_impl.py ref_moe2 OUT.json
        tests/test_ep.py's MoE program (``torch_moe_impl.jax_program``),
        unsharded, x64, 2 iterations.

    RANK=i WORLD_SIZE=N MASTER_ADDR=localhost MASTER_PORT=port \\
        python tests/torch_three_axes_impl.py rank OUT.json WORK_DIR GROUP
        One rank of the port; rank 0 writes the results. GROUP:

        ``m3pp`` (``dp:1,mdl:2,pp:2,sp:2``, 8 ranks, M 2): the pipelined
        transformer under ``strategy="tp"`` with
        ``models.COMPOSED_SHARD_RULES`` (Megatron inside GPipe stages, the
        ``sp`` ranks repeat): the forward and every gradient,
        ``sharded_norm``, darts and CG ``"jvp"``, ITD, compiled blocks
        against driver mode and a run cut and auto-resumed (bit for bit),
        the collective calls by group against ``dp:2,mdl:2,pp:2``'s (the
        same ranks; a dp axis changes no model-axis collective), the
        ``sp`` replicas' states, and tutorial 7 on the mesh.
        ``m3sp`` (``dp:1,mdl:2,sp:2,ep:2``, 8 ranks): the same module built
        with ``seq_axis="sp"`` under ``models.SP_COMPOSED_SHARD_RULES``
        (Megatron-SP, the ``ep`` ranks repeat); darts.
        ``m3moe`` (``dp:1,ep:2,mdl:2,pp:2``, 8 ranks): the MoE program under
        ``strategy="tp"`` with ``MOE_COMPOSED_SHARD_RULES`` (experts over
        ``ep``, hidden columns over ``mdl``, the ``pp`` ranks repeat);
        darts and ITD.
        ``m4`` (``dp:1,ep:2,mdl:2,pp:2,sp:2``, 16 ranks): the MoE program,
        darts, 2 steps (the ``pp`` and ``sp`` ranks repeat).
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch_composed_impl as ci  # noqa: E402
import torch_parallel_impl as tpi  # noqa: E402
import torch_pp_impl as ppi  # noqa: E402

M3PP, M3SP, M3MOE = "dp:1,mdl:2,pp:2,sp:2", "dp:1,mdl:2,sp:2,ep:2", "dp:1,ep:2,mdl:2,pp:2"
M4 = "dp:1,ep:2,mdl:2,pp:2,sp:2"
# m3pp's model-axis collectives are held to those of this mesh on the same
# ranks: the dp axis changes only the batch groups' size
M3PP_WITHOUT_SP = "dp:2,mdl:2,pp:2"
GROUPS = {"m3pp": M3PP, "m3sp": M3SP, "m3moe": M3MOE, "m4": M4}
WORLDS = {"m3pp": 8, "m3sp": 8, "m3moe": 8, "m4": 16}
# each group's JAX references: (name, script, mode)
REFS = {"ref_darts": ("torch_pp_impl.py", "ref", "darts"),
        "ref_cg_jvp": ("torch_pp_impl.py", "ref", "cg_jvp"),
        "ref_itd_pipe": ("torch_itd_parallel_impl.py", "ref", "pipe"),
        "ref_t7": ("torch_three_axes_impl.py", "ref_t7", None),
        "ref_moe": ("torch_tp_impl.py", "ref_moe", None),
        "ref_itd_moe": ("torch_itd_parallel_impl.py", "ref", "moe"),
        "ref_moe2": ("torch_three_axes_impl.py", "ref_moe2", None)}
GROUP_REFS = {"m3pp": ("ref_darts", "ref_cg_jvp", "ref_itd_pipe", "ref_t7"),
              "m3sp": ("ref_darts",), "m3moe": ("ref_moe", "ref_itd_moe"), "m4": ("ref_moe2",)}
M3PP_PROGRAMS = ("tp:darts", "tp:cg_jvp")
# tutorial 7 small: its pp program at these widths, a global batch of 32
T7 = ["--vocab_size", "64", "--seq_len", "8", "--dim", "16", "--depth", "4", "--heads", "2"]
T7_ITERS, T7_BATCH = 3, 32
M4_ITERS = 2
TIMEOUT = 300


# ---------------------------------------------------------------------------
# this file's JAX references
# ---------------------------------------------------------------------------


def run_ref_t7(out):
    """The JAX tutorial 7's pp program, sequential, at T7's widths."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from betty_tpu import Config, Engine, EngineConfig, ImplicitProblem, optim
    from betty_tpu.models import MetaWeightNet, make_pipelined_transformer
    from betty_tpu.module import from_flax
    from betty_tpu_torch import convert

    jax.config.update("jax_enable_x64", True)
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    vocab, length, dim, depth, heads = (int(T7[i]) for i in range(1, len(T7), 2))

    def loader(seed):
        r = np.random.RandomState(seed)
        while True:
            yield (r.randint(2, vocab, size=(T7_BATCH, length)).astype(np.int32),
                   r.randint(0, 2, size=T7_BATCH).astype(np.int32))

    class Classifier(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            ce = optax.softmax_cross_entropy_with_integer_labels(self.module(ids), y)
            return jnp.mean(self.reweight(jax.lax.stop_gradient(ce)) * ce)

    class Reweight(ImplicitProblem):
        def training_step(self, batch):
            ids, y = batch
            return optax.softmax_cross_entropy_with_integer_labels(self.classifier(ids),
                                                                   y).mean()

    module = make_pipelined_transformer(None, vocab_size=vocab, max_len=length, dim=dim,
                                        depth=depth, heads=heads, num_classes=2,
                                        rng=jax.random.PRNGKey(0))
    clf = Classifier("classifier", module=module, optimizer=optim.adamw(lr=1e-4),
                     train_data_loader=loader(0), config=Config(type="darts", unroll_steps=1))
    rw = Reweight("reweight", module=from_flax(MetaWeightNet(), jnp.zeros((T7_BATCH,)),
                                               rng=jax.random.PRNGKey(1), train_kwarg="train"),
                  optimizer=optim.adam(lr=1e-4), train_data_loader=loader(1),
                  config=Config(type="darts", log_step=10))
    engine = Engine(config=EngineConfig(train_iters=T7_ITERS), problems=[rw, clf],
                    dependencies={"u2l": {rw: [clf]}, "l2u": {clf: [rw]}})
    engine.states = tpi._f64_jax(engine.states)

    def port(states):
        return {"classifier": convert.from_jax_pipelined(numpy(states["classifier"]["params"]),
                                                         dtype=torch.float64),
                "reweight": convert.from_flax_mwn(numpy(states["reweight"]["params"]),
                                                  dtype=torch.float64)}

    init = port(engine.states)
    tpi.hand_over(os.path.join(os.path.dirname(out), "init_t7.pt"), init)
    engine.run()
    with open(out, "w") as f:
        json.dump({"final": {n: tpi._lists(t) for n, t in port(engine.states).items()},
                   "init": {n: tpi._lists(t) for n, t in init.items()}}, f)
    print("REF_OK", flush=True)


def run_ref_moe2(out):
    """tests/test_ep.py's MoE program, unsharded, ``M4_ITERS`` iterations."""
    import torch_moe_impl

    torch_moe_impl.ITERS = M4_ITERS
    jeng = torch_moe_impl.jax_program()
    init = torch_moe_impl.port_params(jeng.states)
    jeng.run()
    lists = lambda tree: {n: {k: v.tolist() for k, v in tpi.leaves(t).items()}  # noqa: E731
                          for n, t in tree.items()}
    with open(out, "w") as f:
        json.dump({"final": lists(torch_moe_impl.port_params(jeng.states)), "init": lists(init)},
                  f)
    print("REF_OK", flush=True)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _compare(res, key, rank, got, want, **info):
    if rank == 0:
        err = tpi.max_err(got, want)
        res[key] = {"ok": err <= 1e-12, "info": {"max_abs_err": err, **info},
                    "params": {n: {k: v.tolist() for k, v in tpi.leaves(t).items()}
                               for n, t in got.items()}}


def _one_process(rank, build):
    """The one-process run's whole parameters on rank 0 (None elsewhere)."""
    if rank != 0:
        return None
    ref = build()
    ref.run()
    return ppi.whole_params(ref)


class CallCounter:
    """The ``torch.distributed`` collective calls made while it is on, by
    ``op:group`` (the mesh's names for its groups: ``batch``, ``model``,
    an axis, ``mdl+pp``; ``other`` for the default group)."""

    OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
           "batch_isend_irecv")

    def __init__(self, mesh):
        import torch.distributed as dist

        labels = {id(g): k for k, g in mesh.axis_groups.items()}
        labels.setdefault(id(mesh.model_group), "model")
        labels[id(mesh.batch_group)] = "batch"
        self.counts, self._saved = {}, {}
        for op in self.OPS:
            orig = self._saved[op] = getattr(dist, op)

            def wrapped(*a, _orig=orig, _op=op, **kw):
                group = a[0][0].group if _op == "batch_isend_irecv" else kw.get("group")
                key = f"{_op}:{labels.get(id(group), 'other')}"
                self.counts[key] = self.counts.get(key, 0) + 1
                return _orig(*a, **kw)

            setattr(dist, op, wrapped)

    def restore(self):
        import torch.distributed as dist

        for op, fn in self._saved.items():
            setattr(dist, op, fn)


def _digests(engine):
    """A digest of the bytes of every tensor of every problem's state as
    this rank holds it."""
    import torch

    from betty_tpu_torch.utils import tree_leaves

    h = hashlib.sha256()
    for p in engine.problems:
        for x in tree_leaves(engine.states[p.name]):
            if isinstance(x, torch.Tensor):
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _replicas_equal(engine, axes):
    """Whether the ranks that differ only in their coordinates on the model
    axes ``axes`` (the axes that repeat the work) hold bit-equal states:
    ``(ok, the number of distinct digests)``."""
    import torch.distributed as dist

    mesh = engine.mesh
    mine = (tuple(mesh.axis_index(a) for a in mesh.model_axes if a not in axes),
            mesh.batch_index, _digests(engine))
    every = [None] * mesh.world
    dist.all_gather_object(every, mine)
    by_place = {}
    for place, b, digest in every:
        by_place.setdefault((place, b), set()).add(digest)
    return all(len(d) == 1 for d in by_place.values()), len({d for *_, d in every})


def case_m3pp_calls(init, res, rank):
    """darts on m3pp and on ``M3PP_WITHOUT_SP`` with the collective calls
    counted by group; the ``sp`` replicas' states after the m3pp run."""
    got = {}
    for mesh_spec in (M3PP, M3PP_WITHOUT_SP):
        eng = ci.engine("tp:darts", mesh_spec, init, 2)
        counter = CallCounter(eng.mesh)
        try:
            eng.run()
        finally:
            counter.restore()
        got[mesh_spec] = counter.counts
        if mesh_spec == M3PP:
            same, distinct = _replicas_equal(eng, ("sp",))
    res["calls"] = {"ok": True, "info": {"counts": got, "sp_replicas_equal": same,
                                         "distinct_states": distinct}}


def case_itd(family, base, res, rank, init, key):
    """``base`` made ITD (``torch_itd_parallel_impl.itd_engine``) against the
    port's one-process ITD run of ``family``."""
    import betty_tpu_torch
    import torch_itd_parallel_impl as ipi

    want = _one_process(rank, lambda: ipi.port_itd(family, None, init))
    eng = ipi.itd_engine(betty_tpu_torch, base, family)
    eng.run()
    _compare(res, key, rank, ppi.whole_params(eng), want, strategy=eng.strategy)


def _t7_engine(mesh_spec, init):
    """tutorial 7's pp program at T7 widths on ``mesh_spec`` (``none``: one
    process), float64, from the JAX reference's initial weights."""
    import importlib

    import torch

    from betty_tpu_torch.utils import tree_map

    t7 = importlib.import_module("betty_tpu_torch.tutorial.7_model_parallelism")
    eng = t7.build_engine(t7.parse_args(
        ["--device", "cpu", "--mode", "pp", "--mesh", mesh_spec, "--num_microbatches", "2",
         "--train_iters", str(T7_ITERS), "--batch_size", str(T7_BATCH)] + T7))
    eng.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                          else t, eng.states)
    for p in eng.problems:
        st = dict(eng.states[p.name])
        st["params"] = p.shard_full_state({"params": tree_map(torch.clone, init[p.name])})[
            "params"]
        eng.states[p.name] = st
    return eng


def case_tutorial(init, res, rank):
    """Tutorial 7's pp mode on m3pp against ``--mesh none``."""
    want = _one_process(rank, lambda: _t7_engine("none", init))
    eng = _t7_engine(M3PP, init)
    held = list(eng.states["classifier"]["params"]["blocks.attn.query.kernel"].shape)
    eng.run()
    _compare(res, "tutorial", rank, ppi.whole_params(eng), want, held=held,
             strategy=eng.strategy)


def case_moe(mesh_spec, init, res, rank, key, iters=None):
    """The MoE program under tp on ``mesh_spec`` against the one-process run;
    the leaves held, the all-gathers by group and the states of the ranks
    that repeat the layer (``pp``, ``sp``)."""
    import torch_composed_sp_moe_impl as spi
    from torch_tp_impl import moe_engine

    extra = ["--train_iters", str(iters)] if iters else []
    want = _one_process(rank, lambda: moe_engine("default", None, init, extra))
    eng = moe_engine("tp", mesh_spec, init, extra)
    held = {k: list(v.shape) for k, v in tpi.leaves(eng.states["inner"]["params"]).items()}
    gathers = spi.run_counting_gathers(eng)
    same, distinct = _replicas_equal(eng, ("pp", "sp"))
    _compare(res, key, rank, ppi.whole_params(eng), want, held=held, gathers=gathers,
             replicas_equal=same, distinct_states=distinct)


def run_rank(out, work_dir, group):
    import torch

    torch.set_num_threads(1)
    from betty_tpu_torch import parallel

    parallel.maybe_init_distributed("cpu", timeout=TIMEOUT)
    rank = torch.distributed.get_rank()
    mesh = GROUPS[group]
    res, t0 = {}, time.time()

    def mark(name):
        res[f"seconds:{name}"] = round(time.time() - t0, 2)

    if group == "m3pp":
        init = tpi.take_over(os.path.join(work_dir, "init.pt"))
        ci.case_forward(mesh, 2, init, res)
        ci.case_programs(mesh, 2, init, res, rank, M3PP_PROGRAMS)
        mark("programs")
        case_m3pp_calls(init, res, rank)
        ci.case_details(mesh, 2, init, work_dir, res)
        mark("details")
        pipe = tpi.take_over(os.path.join(work_dir, "init_pipe.pt"))
        from betty_tpu_torch.models import COMPOSED_SHARD_RULES

        case_itd("pipe", ppi.port_engine("darts", "tp", mesh, pipe, 2,
                                         rules=COMPOSED_SHARD_RULES), res, rank, pipe, "itd")
        mark("itd")
        case_tutorial(tpi.take_over(os.path.join(work_dir, "init_t7.pt")), res, rank)
    elif group == "m3sp":
        import torch_composed_sp_moe_impl as spi

        init = tpi.take_over(os.path.join(work_dir, "init.pt"))
        want = _one_process(rank, lambda: spi.engine("tp:darts", None, init))
        eng = spi.engine("tp:darts", mesh, init)
        held = list(eng.states["classifier"]["params"]["blocks.attn.query.kernel"].shape)
        gathers = spi.run_counting_gathers(eng)
        same, distinct = _replicas_equal(eng, ("ep",))
        _compare(res, "tp:darts", rank, ppi.whole_params(eng), want, held=held,
                 gathers=gathers, ep_replicas_equal=same, distinct_states=distinct)
    elif group == "m3moe":
        from torch_tp_impl import moe_engine

        init = tpi.take_over(os.path.join(work_dir, "init_moe.pt"))
        case_moe(mesh, init, res, rank, "moe")
        mark("moe")
        case_itd("moe", moe_engine("tp", mesh, init), res, rank, init, "itd")
    else:
        case_moe(mesh, tpi.take_over(os.path.join(work_dir, "init_moe.pt")), res, rank, "moe",
                 iters=M4_ITERS)
    mark("all")
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    torch.distributed.barrier()
    print("RANK_OK", rank, flush=True)


# ---------------------------------------------------------------------------
# the launcher of the test files
# ---------------------------------------------------------------------------


def launch(work, groups):
    """The JAX references of ``groups`` and their ranks side by side
    (torchrun's variables, gloo, one thread a process); every process has
    ``TIMEOUT`` seconds, a failure or a timeout raises. The JSON results by
    name. ``m4``'s initial weights come from ``ref_moe``'s hand-over, which
    ``ref_moe2`` (the same weights) leaves to it: ``m4`` alone starts
    ``ref_moe`` too."""
    import subprocess

    from test_torch_parallel import _env, _free_port

    refs = [r for g in groups for r in GROUP_REFS[g]]
    if "m4" in groups and "ref_moe" not in refs:
        refs.append("ref_moe")
    procs = []
    for name in dict.fromkeys(refs):
        script, mode, case = REFS[name]
        argv = [os.path.join(HERE, script), mode, os.path.join(work, f"{name}.json")]
        procs.append((name, subprocess.Popen(
            [sys.executable] + argv + ([case] if case else []), env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for group in groups:
        port, world = _free_port(), WORLDS[group]
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
    for name in list(dict.fromkeys(refs)) + list(groups):
        with open(os.path.join(work, f"{name}.json")) as fh:
            out[name] = json.load(fh)
    return out


if __name__ == "__main__":
    if sys.argv[1] == "ref_t7":
        run_ref_t7(sys.argv[2])
    elif sys.argv[1] == "ref_moe2":
        run_ref_moe2(sys.argv[2])
    else:
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4])
