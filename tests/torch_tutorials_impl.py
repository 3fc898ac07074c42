"""The tutorials of the JAX package (``tutorial/``) and the port's
(``betty_tpu_torch/tutorial/``), run from the same weights on the same
batches for a few iterations.

Each JAX tutorial runs as it is (1 to 4 as scripts through ``runpy``, 6
and 8 through their functions), with ``betty_tpu.engine.Engine.run``
wrapped so that it runs ``ITERS`` iterations and, but for tutorial 4, casts
the states and the loaders' inputs to float64 first; the wrapper records
each engine and its initial states. The port's tutorial then starts from
those weights (``convert.from_flax_mlp``), in float64, and after the run
both problems' parameters must agree within 1e-10 (counts equal);
tutorial 2's validation accuracies must be equal; tutorial 4 (bf16 steps)
compares the problems' fixed-batch losses, evaluated in float32 at either
side's final parameters, within 2e-2 relative (``case_t4``).

Run as a subprocess by test_torch_tutorials.py (float64 JAX must not leak
into the float32 test process); prints one ``OK``/``FAIL`` JSON line a
case.

    python tests/torch_tutorials_impl.py t1 t1_baseline t2 t3 t4 t6_0 t6_1 t6_2 t8
"""

import contextlib
import importlib
import importlib.util
import json
import os
import runpy
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tutorial"))

import betty_tpu.engine as jengine  # noqa: E402
from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.utils import tree_map  # noqa: E402

ITERS = 8
TOL = 1e-10
NUMPY = {torch.float64: np.float64, torch.float32: np.float32}
BF16_TOL = 2e-2


def port_tutorial(name):
    return importlib.import_module(f"betty_tpu_torch.tutorial.{name}")


@contextlib.contextmanager
def jax_runs(iters, f64=True):
    """Wrap ``betty_tpu``'s ``Engine.run``: ``iters`` iterations, float64
    states and inputs; yields the list of ``(engine, initial states)``."""
    orig, runs = jengine.Engine.run, []

    def run(self):
        self.train_iters = iters
        if f64:
            self.states = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, self.states)
            for p in self.problems:
                for dl in p.train_data_loader:
                    cast = jnp.asarray if dl.device else np.asarray
                    dl.arrays = (cast(dl.arrays[0], np.float64),) + tuple(dl.arrays[1:])
        runs.append((self, jax.tree_util.tree_map(np.asarray, self.states)))
        return orig(self)

    jengine.Engine.run = run
    try:
        yield runs
    finally:
        jengine.Engine.run = orig


def run_jax_script(name, argv=()):
    saved = sys.argv
    sys.argv = [name] + list(argv)
    try:
        return runpy.run_path(str(ROOT / "tutorial" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = saved


def load_jax_module(name):
    spec = importlib.util.spec_from_file_location(f"jax_tutorial_{name}",
                                                  ROOT / "tutorial" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_params(jstates, dtype):
    return {name: convert.from_flax_mlp(s["params"], dtype=dtype) for name, s in jstates.items()}


def start_from(teng, jstates, dtype):
    """The port's engine at JAX's initial weights, its states and inputs in
    ``dtype``."""
    teng.states = tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point()
                           else t, teng.states)
    for name, params in port_params(jstates, dtype).items():
        teng.states[name]["params"] = params
    for p in teng.problems:
        for dl in p.train_data_loader:
            x = dl.arrays[0]
            x = x.to(dtype) if torch.is_tensor(x) else np.asarray(x, NUMPY[dtype])
            dl.arrays = (x, *dl.arrays[1:])


def compare(jeng, teng, dtype=torch.float64):
    want = port_params(jax.tree_util.tree_map(np.asarray, jeng.states), dtype)
    errs = {n: max(float((teng.states[n]["params"][k] - t).abs().max()) for k, t in w.items())
            for n, w in want.items()}
    counts = ([p.count for p in teng.problems], [p.count for p in jeng.problems])
    return errs, counts


def fixed_losses_jax(jeng):
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in jeng.states.items()}
    out = {}
    for p in jeng.problems:
        dl = p.train_data_loader[0]
        batch = tuple(jnp.asarray(a[:dl.batch_size]) for a in dl.arrays)
        out[p.name] = float(p.eval_loss(ctx, batch)[0])
    return out


def fixed_losses_port(teng):
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in teng.states.items()}
    out = {}
    with torch.no_grad():
        for p in teng.problems:
            dl = p.train_data_loader[0]
            batch = tuple(torch.as_tensor(np.asarray(a[:dl.batch_size])) for a in dl.arrays)
            out[p.name] = float(p.eval_loss(ctx, batch)[0])
    return out


def script_case(name, argv=(), port_argv=(), f64=True):
    with jax_runs(ITERS, f64) as runs:
        scope = run_jax_script(name, argv)
    (jeng, init), = runs
    mod = port_tutorial(name)
    teng = mod.build_engine(mod.parse_args(["--device", "cpu", "--train_iters", str(ITERS),
                                            *port_argv]))
    dtype = torch.float64 if f64 else torch.float32
    start_from(teng, init, dtype)
    teng.run()
    return scope, jeng, teng


def case_t1(baseline):
    extra = ["--baseline"] if baseline else []
    _, jeng, teng = script_case("1_quick_start", extra, extra)
    errs, counts = compare(jeng, teng)
    ok = max(errs.values()) <= TOL and counts[0] == counts[1]
    return ok, {"max_abs_err": errs, "counts": counts}


def case_t2():
    _, jeng, teng = script_case("2_validation", (), ["--valid_step", "4"])
    errs, counts = compare(jeng, teng)
    jeng.eval()
    teng.eval()
    accs = (float(teng.validation()["acc"]), float(jeng.validation()["acc"]))
    ok = max(errs.values()) <= TOL and counts[0] == counts[1] and accs[0] == accs[1]
    return ok, {"max_abs_err": errs, "counts": counts, "acc": accs}


def case_t3():
    with tempfile.TemporaryDirectory() as cwd:
        here = os.getcwd()
        os.chdir(cwd)
        try:
            _, jeng, teng = script_case("3_logging")
        finally:
            os.chdir(here)
    errs, counts = compare(jeng, teng)
    ok = max(errs.values()) <= TOL and counts[0] == counts[1]
    return ok, {"max_abs_err": errs, "counts": counts}


def case_t4():
    """bf16 steps on float32 masters. The fixed-batch losses of either
    side's final parameters, both evaluated by the port in float32, within
    2e-2 relative. The bf16 losses are reported beside them: there the two
    cross-entropies round differently (optax's log-sum-exp rounds each op
    to bf16, ``F.cross_entropy`` rounds its float32 result once), which
    moves the classifier's loss, a mean of near-zero terms, by up to a
    quarter at JAX's own parameters."""
    from betty_tpu_torch.problems.problem import force_fp32

    _, jeng, teng = script_case("4_memory_optimization", f64=False)
    bf16 = {"port": fixed_losses_port(teng), "jax": fixed_losses_jax(jeng)}
    with force_fp32():
        got = fixed_losses_port(teng)
        for name, params in port_params(jax.tree_util.tree_map(np.asarray, jeng.states),
                                        torch.float32).items():
            teng.states[name]["params"] = params
        want = fixed_losses_port(teng)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    counts = ([p.count for p in teng.problems], [p.count for p in jeng.problems])
    ok = max(rel.values()) <= BF16_TOL and counts[0] == counts[1]
    return ok, {"fp32_losses": got, "fp32_losses_at_jax_params": want, "rel_err": rel,
                "bf16_losses": bf16, "counts": counts}


def case_t6(i):
    jmod = load_jax_module("6_performance")
    tmod = port_tutorial("6_performance")
    name, cfg = tmod.CONFIGS[i]  # the JAX tutorial's four, in its order
    iters = 16
    with jax_runs(iters) as runs:
        jmod.build(*cfg).run()
    (jeng, init), = runs
    teng = tmod.build(*cfg, device="cpu", train_iters=iters)
    teng.config.block_periods = 1
    start_from(teng, init, torch.float64)
    teng.run()
    errs, counts = compare(jeng, teng)
    ok = max(errs.values()) <= TOL and counts[0] == counts[1]
    if cfg[0]:
        ok = ok and teng.block_runner is not None and teng.block_runner.periods_run > 0
    return ok, {"config": name, "max_abs_err": errs, "counts": counts}


def case_t8():
    jmod = load_jax_module("8_custom_solver")
    with jax_runs(ITERS) as runs:
        jmod.main()
    (jeng, init), = runs
    tmod = port_tutorial("8_custom_solver")
    teng = tmod.build_engine(tmod.parse_args(["--device", "cpu", "--train_iters", str(ITERS)]))
    start_from(teng, init, torch.float64)
    teng.run()
    errs, counts = compare(jeng, teng)
    want = float(np.linalg.norm(np.asarray(
        jax.tree_util.tree_leaves(jeng.states["reweight"]["params"])[0])))
    norms = (tmod.first_leaf_norm(teng), want)
    ok = (max(errs.values()) <= TOL and counts[0] == counts[1]
          and abs(norms[0] - norms[1]) <= TOL)
    return ok, {"max_abs_err": errs, "counts": counts, "first_leaf_norm": norms}


CASES = {"t1": lambda: case_t1(False), "t1_baseline": lambda: case_t1(True), "t2": case_t2,
         "t3": case_t3, "t4": case_t4, "t6_0": lambda: case_t6(0), "t6_1": lambda: case_t6(1),
         "t6_2": lambda: case_t6(2), "t8": case_t8}


def main(cases):
    torch.set_num_threads(1)
    failed = []
    for case in cases:
        ok, info = CASES[case]()
        print(("OK " if ok else "FAIL ") + json.dumps({"case": case, **info}), flush=True)
        if not ok:
            failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
