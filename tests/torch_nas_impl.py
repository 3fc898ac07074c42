"""The DARTS examples of the JAX package and the port's, run in float64 from
the same weights on the same batches.

* ``search``: ``examples/neural_architecture_search/main.py`` and the port's
  ``examples/neural_architecture_search.py`` at C2 L1 (one reduction cell)
  B4, darts with ``roll_back=True``: after ``SEARCH_PERIODS`` meta-periods
  the supernet's params and batch_stats and the alphas within TOL, and the
  same genotype.
* ``hypergradient``: one darts hypergradient of the search at C4 L3 (two
  normal cells around a reduction): ``betty_tpu``'s darts solver and the
  port's on the same states and batches, after the same starting vector v
  (the arch loss's gradient at the classifier's params).
* ``eval``: ``examples/neural_architecture_search/train.py`` and the port's
  ``examples/nas_eval.py`` on DARTS_V2 at C4 L4 B8 with the auxiliary head,
  cutout and drop-path 0, gradients clipped (the clip is active), 3 steps.

The JAX side starts from the port's weights (``torch_darts_common.to_flax``,
the inverse of ``convert.from_flax_darts``). XLA compiles the supernet's whole update step
slowly on the CPU (minutes at L1), so the JAX problems' update functions
run op by op here, and only the supernet's apply is one jitted function
(its forward and backward compiled once per differentiation pattern); the
arithmetic is the example's.

Run as a subprocess by test_torch_nas.py (float64 JAX must not leak into
the float32 test process):

    python tests/torch_nas_impl.py search hypergradient eval
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.examples import nas_eval as teval  # noqa: E402
from betty_tpu_torch.examples import neural_architecture_search as tnas  # noqa: E402
from betty_tpu_torch.models.darts import DARTS_V2, DARTSEvalNetwork, DARTSNetwork  # noqa: E402
from betty_tpu_torch.utils import tree_map  # noqa: E402
from torch_darts_common import to_flax  # noqa: E402

TOL = 1e-8
SEARCH_PERIODS = 4
SEARCH_ARGV = ["--batch_size", "4", "--channels", "2", "--layers", "1", "--train_size", "16",
               "--train_iters", str(SEARCH_PERIODS), "--valid_step", "1000"]
HYPER_ARGV = ["--batch_size", "4", "--channels", "4", "--layers", "3", "--train_size", "16",
              "--train_iters", "1", "--valid_step", "1000"]
EVAL_ARGV = ["--batch_size", "8", "--train_size", "24", "--epochs", "1", "--init_channels", "4",
             "--layers", "4", "--auxiliary", "--cutout", "--drop_path_prob", "0.0",
             "--grad_clip", "0.5", "--valid_every_epochs", "10"]


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _f64_port(engine):
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    for prob in engine.problems:
        for loader in prob.train_data_loader:
            loader.arrays = (np.asarray(loader.arrays[0], np.float64), *loader.arrays[1:])


def _f64_jax(engine):
    engine.states = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, engine.states)
    for prob in engine.problems:
        loaders = prob.train_data_loader
        for dl in (loaders if isinstance(loaders, (list, tuple)) else [loaders]):
            dl.arrays = (np.asarray(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])


def _op_by_op(engine, jitted):
    """Each JAX problem's update function unjitted, and the modules of
    ``jitted`` (problem names) applied through one jitted function."""
    for p in engine.problems:
        cache = {}

        def get(apply_update, advance_sched=True, _p=p, _cache=cache):
            key = (bool(apply_update), bool(advance_sched))
            if key not in _cache:
                _cache[key] = _p.build_update_fn(apply_update=key[0], advance_sched=key[1])
            return _cache[key]

        p._get_update_fn = get
        if p.name in jitted:
            p.module_fn.apply_fn = jax.jit(p.module_fn.apply_fn,
                                           static_argnames=("train", "mutable"))


def _max_err(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _search_engines(argv, jit_apply=True):
    """The port's and the JAX example's search engines, float64, from the
    port's weights (``jit_apply``: the supernet's apply jitted)."""
    jmod = load("nas_search_parity", "neural_architecture_search/main.py")
    targs = tnas.parse_args(argv + ["--device", "cpu"])
    teng = tnas.build_engine(targs)
    _f64_port(teng)
    net = DARTSNetwork(channels=targs.channels, layers=targs.layers)  # the structure
    clf = teng.states["classifier"]
    variables = to_flax(net, clf["params"], clf["extra"]["batch_stats"])
    from_flax = jmod.from_flax
    jmod.from_flax = lambda module, *a, **kw: from_flax(module, *a, variables=variables, **kw)
    jeng = jmod.build_engine(jmod.parse_args(argv))
    st = dict(jeng.states["arch"])
    st["params"] = {k: t.numpy() for k, t in teng.states["arch"]["params"].items()}
    jeng.states["arch"] = st
    _f64_jax(jeng)
    _op_by_op(jeng, {"classifier"} if jit_apply else set())
    return jmod, jeng, teng, net


def _supernet_errs(jeng, teng, net):
    jc = jax.tree_util.tree_map(np.asarray, jeng.states["classifier"])
    params, stats = convert.from_flax_darts(
        {"params": jc["params"], "batch_stats": jc["extra"]["batch_stats"]}, net,
        dtype=torch.float64)
    got = teng.states["classifier"]
    assert set(got["params"]) == set(params)
    assert set(got["extra"]["batch_stats"]) == set(stats)
    alphas = convert.from_flax_alphas(jax.tree_util.tree_map(np.asarray,
                                                             jeng.states["arch"]["params"]),
                                      dtype=torch.float64)
    return {"params": _max_err(params, got["params"]),
            "batch_stats": _max_err(stats, got["extra"]["batch_stats"]),
            "alphas": _max_err(alphas, teng.states["arch"]["params"])}, params, alphas


def case_search():
    jmod, jeng, teng, net = _search_engines(SEARCH_ARGV)
    init = {k: t.clone() for k, t in teng.states["arch"]["params"].items()}
    jeng.run()
    teng.run()
    counts = {p.name: p.count for p in teng.problems}
    assert counts == {p.name: p.count for p in jeng.problems} == {
        "arch": SEARCH_PERIODS, "classifier": SEARCH_PERIODS}, counts
    errs, _, alphas = _supernet_errs(jeng, teng, net)
    from betty_tpu.models.darts import derive_genotype as jderive
    from betty_tpu_torch.models.darts import derive_genotype as tderive
    same = tderive(teng.states["arch"]["params"]) == jderive(jeng.states["arch"]["params"])
    moved = _max_err(init, teng.states["arch"]["params"])
    return errs, moved, {"same_genotype": bool(same)}


def case_hypergradient():
    """v = d(arch loss)/d(classifier params) at the start, then each
    package's darts solver on it."""
    import jax.numpy as jnp
    from betty_tpu.hypergradient.darts import darts as jdarts
    from betty_tpu.problems.problem import ctx_replace as jreplace
    from betty_tpu_torch.hypergradient.darts import darts as tdarts
    from betty_tpu_torch.problems.problem import ctx_replace as treplace
    from betty_tpu_torch.utils import grad as tgrad

    # op by op: the three gradients share their primitives' compilations
    jmod, jeng, teng, net = _search_engines(HYPER_ARGV, jit_apply=False)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        batches = {p.name: p.get_batch() for p in eng.problems}
        if name == "jax":
            batches = jax.tree_util.tree_map(jnp.asarray, batches)
        ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in eng.states.items()}
        replace = jreplace if name == "jax" else treplace

        def arch_loss(w, _eng=eng, _ctx=ctx, _b=batches, _r=replace, _n=name):
            rng = jax.random.PRNGKey(0) if _n == "jax" else 0
            return _eng.arch.eval_loss(_r(_ctx, "classifier", w), _b["arch"], rng=rng)[0]

        grad = jax.grad if name == "jax" else tgrad
        v = grad(arch_loss)(ctx["classifier"]["params"])
        solver = jdarts if name == "jax" else tdarts
        rng = jax.random.PRNGKey(0) if name == "jax" else 0
        h = solver(v, eng.classifier, eng.arch, ctx, eng.states, batches["classifier"], rng)
        out[name] = (v, h)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jv = convert.from_flax_darts(
        {"params": host(out["jax"][0]),
         "batch_stats": host(jeng.states["classifier"]["extra"]["batch_stats"])}, net,
        dtype=torch.float64)[0]
    jh = convert.from_flax_alphas(host(out["jax"][1]), dtype=torch.float64)
    tv, th = out["port"]
    scale = max(float(t.abs().max()) for t in jh.values())
    return ({"v": _max_err(jv, tv), "hypergradient": _max_err(jh, th)}, scale,
            {"hypergradient_scale": scale})


def case_eval():
    import tempfile

    from betty_tpu.models.darts import DARTS_V2 as JDARTS_V2, genotype_to_json

    jmod = load("nas_eval_parity", "neural_architecture_search/train.py")
    with tempfile.TemporaryDirectory() as tmp:
        gfile = Path(tmp) / "genotype.json"
        gfile.write_text(genotype_to_json(JDARTS_V2))  # written by the JAX package
        argv = EVAL_ARGV + ["--genotype-file", str(gfile)]
        targs = teval.parse_args(argv + ["--device", "cpu"])
        teng = teval.build_engine(targs)
        _f64_port(teng)
        net = DARTSEvalNetwork(DARTS_V2, channels=targs.init_channels, layers=targs.layers,
                               auxiliary=True)  # the structure
        st = teng.states["network"]
        variables = to_flax(net, st["params"], st["extra"]["batch_stats"])
        from_flax = jmod.from_flax
        jmod.from_flax = lambda module, *a, **kw: from_flax(module, *a, variables=variables, **kw)
        jeng = jmod.build_engine(jmod.parse_args(argv))
    _f64_jax(jeng)
    _op_by_op(jeng, set())
    init = {k: t.clone() for k, t in teng.states["network"]["params"].items()}

    # the clip is active: the first step's gradient norm exceeds it
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in teng.states.items()}
    ld = teng.network.train_data_loader[0]
    first = teval.EvalLoader(*ld.arrays, ld.batch_size, drop_path_prob=ld.drop_path_prob,
                             epochs=ld.epochs, cutout_length=ld.cutout_length, seed=ld.seed)
    batch = teng.network._convert_batch(next(iter(first)))
    from betty_tpu_torch.problems.problem import ctx_replace
    from betty_tpu_torch.utils import grad as tgrad, tree_norm

    g = tgrad(lambda w: teng.network.eval_loss(ctx_replace(ctx, "network", w), batch,
                                               rng=0)[0])(ctx["network"]["params"])
    norm = float(tree_norm(g))

    jeng.run()
    teng.run()
    assert teng.network.count == jeng.network.count == 3
    jn = jax.tree_util.tree_map(np.asarray, jeng.states["network"])
    params, stats = convert.from_flax_darts(
        {"params": jn["params"], "batch_stats": jn["extra"]["batch_stats"]}, net,
        dtype=torch.float64)
    got = teng.states["network"]
    errs = {"params": _max_err(params, got["params"]),
            "batch_stats": _max_err(stats, got["extra"]["batch_stats"])}
    moved = _max_err(init, got["params"])
    return errs, moved, {"first_grad_norm": norm, "clip": 0.5, "clipped": norm > 0.5}


CASES = {"search": case_search, "hypergradient": case_hypergradient, "eval": case_eval}


def main(cases):
    failed = []
    for case in cases:
        errs, moved, extra = CASES[case]()
        ok = (max(errs.values()) <= TOL and moved > 0
              and extra.get("same_genotype", True) and extra.get("clipped", True))
        print(("OK " if ok else "FAIL ") + json.dumps({"case": case, "max_abs_err": errs,
                                                     "moved": moved, **extra}), flush=True)
        if not ok:
            failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
