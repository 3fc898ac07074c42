"""Iterative differentiation (``IterativeProblem``) and the ``reinforce``
solver of the port against betty_tpu, in float64 (JAX with x64).

Cases (``python tests/torch_itd_impl.py [case ...]``, all by default):

* ``maml``, ``maml_gas``: the cases of tests/test_itd.py. The meta step
  through a 3-step SGD unroll (and through 2 steps of 2 accumulated
  micro-batches) against betty_tpu and the derivative written out by
  hand, within 1e-10.
* ``warns``: ``first_order=False`` above an ``ImplicitProblem`` child warns
  with betty_tpu's text; above an ``IterativeProblem`` child nothing warns.
* ``rollback_restep``: roll_back with gas 2 over four windows: the re-step's
  batch is not recorded, and both problems' params match betty_tpu.
* ``replay``: the replay of an unroll with momentum, an LR schedule and
  gradient clipping lands on the eager parameters (within 1e-12) and both
  match betty_tpu's (within 1e-10). Dropout 0: the random streams differ.
* ``optimizers``: the MAML meta step through SGD with nesterov momentum and
  weight decay, Adam and AdamW (schedules on two of them), two windows,
  within 1e-10 of betty_tpu: every optimizer differentiable end to end.
* ``reinforce``: the solver on the bilevel logistic fixture with JAX's
  directions injected (drawn with JAX's own keys), called directly and
  through two meta steps of an Engine, within 1e-10.

Each case prints ``OK <case> ...`` or ``FAIL <case> ...``; run as a
subprocess by test_torch_itd.py and test_torch_reinforce.py (float64 JAX
must not leak into the float32 test process).
"""

import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden_impl as g  # noqa: E402  (enables float64 in JAX and torch)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import betty_tpu  # noqa: E402
from betty_tpu.hypergradient.reinforce import reinforce as jax_reinforce  # noqa: E402
from betty_tpu.module import from_fn as jfrom_fn  # noqa: E402
from betty_tpu_torch import (Config, Engine, EngineConfig, ImplicitProblem,  # noqa: E402
                             IterativeProblem, optim)
from betty_tpu_torch.hypergradient import jvp_fn_mapping, reinforce  # noqa: E402
from betty_tpu_torch.module import from_fn  # noqa: E402
from torch_solvers_impl import build_port, port_direct_v  # noqa: E402

TOL = 1e-10
D = 5
INNER_STEPS = 3
INNER_LR = 0.1
META_LR = 0.5
rng = np.random.RandomState(7)
T_INNER = rng.randn(D)
T_OUTER = rng.randn(D)
THETA0 = rng.randn(D)


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# the MAML program of tests/test_itd.py on both sides
# ---------------------------------------------------------------------------


class JMeta(betty_tpu.ImplicitProblem):
    def training_step(self, batch):
        return 0.5 * jnp.sum((self.adapt.params["w"] - batch) ** 2)


class JAdapt(betty_tpu.IterativeProblem):
    def training_step(self, batch):
        return 0.5 * jnp.sum((self.module() - batch) ** 2)

    def on_inner_loop_start(self):
        self.set_params({"w": self.meta.params["w"]})

    def unroll_init(self, start_params):
        return {"w": self.meta.params["w"]}


class TMeta(ImplicitProblem):
    def training_step(self, batch):
        return 0.5 * torch.sum((self.adapt.params["w"] - batch) ** 2)


class TAdapt(IterativeProblem):
    def training_step(self, batch):
        return 0.5 * torch.sum((self.module() - batch) ** 2)

    def on_inner_loop_start(self):
        self.set_params({"w": self.meta.params["w"]})

    def unroll_init(self, start_params):
        return {"w": self.meta.params["w"]}


def maml_pair(targets, unroll, gas=1, iters=None, roll_back=False, inner_opt=None):
    """The JAX and the port engine of the MAML program, run. ``inner_opt``:
    ``(name, kwargs)`` of the inner optimizer (SGD at INNER_LR by default)."""
    iters = iters if iters is not None else unroll * gas
    name, kwargs = inner_opt or ("sgd", {"lr": INNER_LR})
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            M, A, ff, opt, C, E, EC = (JMeta, JAdapt, jfrom_fn, betty_tpu.optim, betty_tpu.Config,
                                       betty_tpu.Engine, betty_tpu.EngineConfig)
            arr, kw = jnp.asarray, {}
        else:
            M, A, ff, opt, C, E, EC = TMeta, TAdapt, from_fn, optim, Config, Engine, EngineConfig
            arr, kw = torch.as_tensor, {"device": "cpu"}
        extra = dict(kwargs)
        if "schedule" in extra:
            extra["schedule"] = opt.step_lr(**extra["schedule"])
        meta = M("meta", module=ff(lambda p: p["w"], {"w": arr(THETA0)}),
                 optimizer=opt.sgd(lr=META_LR), train_data_loader=[arr(T_OUTER)],
                 config=C(first_order=False))
        adapt = A("adapt", module=ff(lambda p: p["w"], {"w": arr(np.zeros(D))}),
                  optimizer=getattr(opt, name)(**extra),
                  train_data_loader=[arr(t) for t in targets],
                  config=C(unroll_steps=unroll, gradient_accumulation=gas))
        engine = E(config=EC(train_iters=iters, roll_back=roll_back), problems=[meta, adapt],
                   dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}}, **kw)
        engine.run()
        out.append((engine, meta, adapt))
    return out


def expected_meta(targets, steps, gas):
    """One SGD meta step with the exact gradient through ``steps`` SGD steps
    of ``gas`` accumulated micro-batches each (torch autograd)."""
    theta = torch.tensor(THETA0, requires_grad=True)
    w = theta
    for s in range(steps):
        grad = sum((w - torch.as_tensor(targets[s * gas + j])) / gas for j in range(gas))
        w = w - INNER_LR * grad
    loss = 0.5 * torch.sum((w - torch.as_tensor(T_OUTER)) ** 2)
    (dtheta,) = torch.autograd.grad(loss, theta)
    return (theta - META_LR * dtheta).detach().numpy()


def case_maml():
    (je, jm, ja), (te, tm, ta) = maml_pair([T_INNER], INNER_STEPS)
    got = te.states["meta"]["params"]["w"].numpy()
    errs = {"betty_tpu": err(got, je.states["meta"]["params"]["w"]),
            "by_hand": err(got, expected_meta([T_INNER] * INNER_STEPS, INNER_STEPS, 1))}
    ok = (ta.count, tm.count) == (ja.count, jm.count) == (INNER_STEPS, 1)
    return ok and max(errs.values()) <= TOL, errs


def case_maml_gas():
    gas, steps = 2, 2
    targets = [rng.randn(D) for _ in range(gas * steps)]
    (je, jm, ja), (te, tm, ta) = maml_pair(targets, steps, gas=gas)
    got = te.states["meta"]["params"]["w"].numpy()
    errs = {"betty_tpu": err(got, je.states["meta"]["params"]["w"]),
            "by_hand": err(got, expected_meta(targets, steps, gas))}
    ok = (ta.count, tm.count) == (ja.count, jm.count) == (gas * steps, 1)
    return ok and max(errs.values()) <= TOL, errs


INNER_OPTIMIZERS = {
    "sgd_nesterov": ("sgd", dict(lr=INNER_LR, momentum=0.9, nesterov=True, weight_decay=5e-4,
                                 schedule=dict(lr=INNER_LR, step_size=2, gamma=0.5))),
    "adam": ("adam", dict(lr=0.05, weight_decay=1e-3)),
    "adamw": ("adamw", dict(lr=0.05, weight_decay=0.01,
                            schedule=dict(lr=0.05, step_size=2, gamma=0.5))),
}


def case_optimizers():
    """The meta step through 4 inner steps of each optimizer (momentum,
    nesterov, weight decay, Adam's bias corrections, decoupled decay, a
    schedule), two windows: betty_tpu's within 1e-10."""
    targets = [rng.randn(D) for _ in range(4)]
    errs = {}
    for label, spec in INNER_OPTIMIZERS.items():
        (je, jm, ja), (te, tm, ta) = maml_pair(targets, 4, iters=8, inner_opt=spec)
        errs[label] = max(err(te.states[n]["params"]["w"], je.states[n]["params"]["w"])
                          for n in ("meta", "adapt"))
        assert tm.count == jm.count == 2
    return max(errs.values()) <= TOL, errs


def case_rollback_restep():
    (je, jm, ja), (te, tm, ta) = maml_pair([T_INNER], INNER_STEPS, gas=2,
                                           iters=4 * INNER_STEPS, roll_back=True)
    errs = {name: err(te.states[name]["params"]["w"], je.states[name]["params"]["w"])
            for name in ("meta", "adapt")}
    recorded = (len(ta._unroll_batches), len(ja._unroll_batches))
    ok = (tm.count == jm.count == 2 and recorded[0] == recorded[1] <= INNER_STEPS * 2
          and bool(torch.isfinite(te.states["meta"]["params"]["w"]).all()))
    return ok and max(errs.values()) <= TOL, {**errs, "recorded": recorded}


class _Spy:
    def __init__(self):
        self.warnings = []

    def warning(self, msg):
        self.warnings.append(msg)

    def info(self, msg):
        pass

    def log(self, *a, **kw):
        pass


def case_warns():
    out = {}
    for side in ("jax", "torch"):
        pkg = betty_tpu if side == "jax" else sys.modules["betty_tpu_torch"]
        ff = jfrom_fn if side == "jax" else from_fn
        arr = jnp.asarray if side == "jax" else torch.as_tensor
        for kind in ("implicit", "iterative"):
            base = pkg.ImplicitProblem if kind == "implicit" else pkg.IterativeProblem

            class Child(base):
                def training_step(self, batch):
                    return 0.5 * ((self.module() - batch) ** 2).sum()

            class Parent(pkg.ImplicitProblem):
                def training_step(self, batch):
                    return 0.5 * ((self.child.params["w"] - batch) ** 2).sum()

            parent = Parent("meta", module=ff(lambda p: p["w"], {"w": arr(np.zeros(D))}),
                            optimizer=pkg.optim.sgd(lr=0.1), train_data_loader=[arr(T_OUTER)],
                            config=pkg.Config(first_order=False))
            child = Child("child", module=ff(lambda p: p["w"], {"w": arr(np.zeros(D))}),
                          optimizer=pkg.optim.sgd(lr=0.1), train_data_loader=[arr(T_INNER)],
                          config=pkg.Config(unroll_steps=1))
            kw = {} if side == "jax" else {"device": "cpu"}
            engine = pkg.Engine(config=pkg.EngineConfig(train_iters=1), problems=[parent, child],
                                dependencies={"u2l": {parent: [child]},
                                              "l2u": {child: [parent]}}, **kw)
            spy = _Spy()
            child.logger = spy
            child.initialize(engine)
            out[(side, kind)] = spy.warnings
    ok = (len(out[("torch", "implicit")]) == 1
          and out[("torch", "implicit")] == out[("jax", "implicit")]
          and "first_order=False" in out[("torch", "implicit")][0]
          and out[("torch", "iterative")] == out[("jax", "iterative")] == [])
    return ok, {"warnings": out[("torch", "implicit")]}


# ---------------------------------------------------------------------------
# the replay of tests/test_itd.py (dropout 0: the random streams differ)
# ---------------------------------------------------------------------------


def _mlp_params(lib):
    r = np.random.RandomState(3)
    raw = {"w1": 0.5 * r.randn(4, 8), "b1": 0.1 * r.randn(8), "w2": 0.5 * r.randn(8, 1),
           "b2": 0.1 * r.randn(1)}
    return {k: lib(v) for k, v in raw.items()}


def case_replay():
    xs = rng.randn(INNER_STEPS * 4, 4)
    ys = rng.randn(INNER_STEPS * 4, 1)
    batches = [(xs[i * 4:(i + 1) * 4], ys[i * 4:(i + 1) * 4]) for i in range(INNER_STEPS)]
    results = {}
    for side in ("jax", "torch"):
        if side == "jax":
            pkg, ff, arr, np_ = betty_tpu, jfrom_fn, jnp.asarray, jnp
            kw = {}
        else:
            pkg, ff, arr, np_ = sys.modules["betty_tpu_torch"], from_fn, torch.as_tensor, torch
            kw = {"device": "cpu"}

        def mlp(p, x, _np=np_):
            return _np.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

        class Meta2(pkg.ImplicitProblem):
            def training_step(self, batch):
                x, y = batch
                return ((self.adapt(x) - y) ** 2).mean()

        class Adapt2(pkg.IterativeProblem):
            def training_step(self, batch):
                x, y = batch
                return ((self.module(x) - y) ** 2).mean()

        meta = Meta2("meta", module=ff(lambda p: p["w"], {"w": arr(np.zeros(1))}),
                     optimizer=pkg.optim.sgd(lr=0.0),
                     train_data_loader=[(arr(xs[:4]), arr(ys[:4]))],
                     config=pkg.Config(first_order=False))
        adapt = Adapt2("adapt", module=ff(mlp, _mlp_params(arr)),
                       optimizer=pkg.optim.sgd(lr=0.3, momentum=0.9,
                                               schedule=pkg.optim.step_lr(0.3, step_size=2,
                                                                          gamma=0.5)),
                       train_data_loader=[(arr(x), arr(y)) for x, y in batches],
                       config=pkg.Config(unroll_steps=INNER_STEPS, gradient_clipping=0.7))
        engine = pkg.Engine(config=pkg.EngineConfig(train_iters=INNER_STEPS),
                            problems=[meta, adapt],
                            dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}}, **kw)
        engine.run()
        ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
        r = jax.random.PRNGKey(99) if side == "jax" else 99
        replayed = adapt.replay_unroll(ctx, adapt.get_unroll_data(), rng=r)
        results[side] = ({k: np.asarray(v) for k, v in engine.states["adapt"]["params"].items()},
                         {k: np.asarray(v.detach() if side == "torch" else v)
                          for k, v in replayed.items()})
    (j_eager, j_replay), (t_eager, t_replay) = results["jax"], results["torch"]
    errs = {"replay_vs_eager": max(err(t_replay[k], t_eager[k]) for k in t_eager),
            "eager_vs_betty_tpu": max(err(t_eager[k], j_eager[k]) for k in t_eager),
            "replay_vs_betty_tpu": max(err(t_replay[k], j_replay[k]) for k in t_eager),
            "moved": max(err(t_eager[k], _mlp_params(np.asarray)[k]) for k in t_eager)}
    ok = (errs["replay_vs_eager"] <= 1e-12 and errs["eager_vs_betty_tpu"] <= TOL
          and errs["replay_vs_betty_tpu"] <= TOL and errs["moved"] > 0)
    return ok, errs


# ---------------------------------------------------------------------------
# reinforce with JAX's directions
# ---------------------------------------------------------------------------


def jax_directions(key, n, like):
    """The directions betty_tpu's reinforce draws from ``key``."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    out = []
    for k in jax.random.split(jax.random.fold_in(key, 0x5E1F), n):
        keys = jax.random.split(k, len(leaves))
        out.append(jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(kk, leaf.shape, leaf.dtype)
                      for kk, leaf in zip(keys, leaves)]))
    return out


def _port_tree(tree):
    return {k: torch.tensor(np.array(v)) for k, v in tree.items()}


def case_reinforce():
    n = 6
    errs = {}
    # the solver called directly on the same context
    cfg = dict(type="reinforce", reinforce_samples=n, reinforce_sigma=0.05, reinforce_alpha=0.02)
    jeng, jout, jin, jctx, jbatch = g.build_jax(g.Config(**cfg), betty_tpu.optim.sgd(lr=0.1))
    teng, tout, tin, tctx, tbatch = build_port(Config(**cfg), optim.sgd(lr=0.1))
    key = jax.random.PRNGKey(5)
    jv = g.j_direct_v(jout, jin, jctx)
    tv = port_direct_v(tout, tctx)
    us = [_port_tree(u) for u in jax_directions(key, n, jctx["outer"]["params"])]
    want = jax_reinforce(jv, jin, jout, jctx, jeng.states, jbatch, key)
    got = reinforce(tv, tin, tout, tctx, teng.states, tbatch, 0,
                    directions=lambda _rng, i, _like: us[i])
    errs["direct"] = err(got["w"], want["w"])

    # two meta steps of an Engine: the directions of each step derived from
    # betty_tpu's key of that step (the outer problem's name and count)
    def run_jax():
        engine, outer, _, _, _ = g.build_jax(g.Config(**cfg, unroll_steps=3),
                                              betty_tpu.optim.sgd(lr=0.1))
        engine.train_iters = 6
        engine.run()
        return engine, outer

    jeng, jout = run_jax()
    teng, tout, _, _, _ = build_port(Config(**cfg, unroll_steps=3), optim.sgd(lr=0.1))
    teng.train_iters = 6

    def injected(_rng, i, like):
        key = jax.random.fold_in(jax.random.PRNGKey(tout._rng_seed), tout.count)
        return _port_tree(jax_directions(key, n, {k: np.asarray(v) for k, v in like.items()})[i])

    saved = jvp_fn_mapping["reinforce"]
    jvp_fn_mapping["reinforce"] = functools.partial(reinforce, directions=injected)
    try:
        teng.run()
    finally:
        jvp_fn_mapping["reinforce"] = saved
    errs["engine"] = max(err(teng.states[name]["params"]["w"], jeng.states[name]["params"]["w"])
                         for name in ("outer", "inner"))
    errs["moved"] = err(teng.states["outer"]["params"]["w"], g.LAM0)
    ok = tout.count == jout.count == 2 and errs["moved"] > 0
    return ok and errs["direct"] <= TOL and errs["engine"] <= TOL, errs


CASES = {"maml": case_maml, "maml_gas": case_maml_gas, "warns": case_warns,
         "rollback_restep": case_rollback_restep, "replay": case_replay,
         "optimizers": case_optimizers, "reinforce": case_reinforce}


def main(names):
    failed = []
    for name in names:
        ok, info = CASES[name]()
        print(("OK " if ok else "FAIL ") + json.dumps({"case": name, **info}, default=str),
              flush=True)
        if not ok:
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
