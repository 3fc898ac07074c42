"""Robust NAS and the 4-level saliency-aware NAS of the JAX package and the
port's, in float64 from the same weights on the same batches.

* ``regularizers``: ``jacobian_reg`` (JAX's direction injected),
  ``cure_reg`` and ``curvature_reg`` (JAX's start injected) of the port's
  ``examples/robust_nas.py`` against ``examples/robust_nas/main.py``'s on
  the same loss (a two-layer tanh-GELU classifier that ignores one input
  feature, so that CURE's ``sign(g)`` holds zeros), the same input: values and
  their gradients to the loss's parameters within 1e-10.
* ``mlp``: the robust program on the ``mlp`` backbone (``MixMLP``), 4
  meta-periods with both regularizers, the Jacobian directions of every
  evaluation drawn as JAX draws them (the evaluating problem's step key):
  alphas and parameters within 1e-8.
* ``darts_jacobian``, ``darts_cure``: the supernet at C2 L1 B2, the
  classifier's regularized loss with one term on, its gradients to the
  supernet's parameters and to the alphas and the running statistics its
  first forward keeps, within 1e-8. (A whole meta-period of JAX's
  second-order supernet takes minutes on the CPU, op by op or compiled by
  XLA; the loss's gradient alone about 40 s op by op for the Jacobian term
  and 70 s for CURE.)
* ``sanas``: the 4-level program (dim 16, 3 classes, batch 32, 2 PGD
  steps, unroll 2 and 2) for 8 inner1 steps: all three problems'
  parameters within 1e-8, 3 paths into the outer problem, counts 8:4:2.
* ``budget``: ``tests/test_examples2.py::test_sanas_budget_receives_data_gradient``'s
  run (6 PGD steps, so the projection binds) and the budget's gradient of
  the inner2 loss at JAX's state, element by element within 1e-10; the
  number of clipped (tied) elements, and what ``torch.clamp`` would have
  given.

Run as a subprocess by the tests (float64 JAX must not leak into the
float32 test process):

    python tests/torch_robust_impl.py regularizers mlp darts_jacobian darts_cure sanas budget
"""

import json
import sys
import zlib
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.examples import robust_nas as trob  # noqa: E402
from betty_tpu_torch.examples import saliency_aware_nas_4_level as tsanas  # noqa: E402
from betty_tpu_torch.models.darts import DARTSNetwork  # noqa: E402
from betty_tpu_torch.models.mlp import MLP  # noqa: E402
from betty_tpu_torch.problems.problem import ctx_replace  # noqa: E402
from betty_tpu_torch.utils import fold_in, grad as tgrad, tree_map  # noqa: E402
from torch_darts_common import to_flax  # noqa: E402
from torch_nas_impl import _f64_jax, _f64_port, _max_err, load  # noqa: E402

TOL = 1e-8
REG_TOL = 1e-10
MLP_PERIODS = 4
ROBUST_ARGV = ["--batch_size", "4", "--train_size", "16", "--valid_step", "1000"]
SANAS = dict(dim=16, classes=3, n=256, batch=32, lr=0.05, arch_lr=1e-3, budget_lr=1e-3,
             pgd_steps=2, pgd_lr=0.05, unroll1=2, unroll2=2, train_iters=8, log_step=-1,
             valid_step=1000)
BUDGET = dict(SANAS, pgd_steps=6, unroll1=1, unroll2=1, train_iters=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the three regularizers on one loss
# ---------------------------------------------------------------------------


def case_regularizers():
    jmod = load("robust_parity", "robust_nas/main.py")
    rng = np.random.RandomState(0)
    B, D, H, C = 4, 12, 16, 5
    x = rng.randn(B, D)
    labels = rng.randint(0, C, B)
    params = {"w1": rng.randn(D, H) * 0.5, "b1": rng.randn(H) * 0.1,
              "w2": rng.randn(H, C) * 0.5, "b2": rng.randn(C) * 0.1}

    # the loss ignores feature 0, so its input gradient there is exactly 0
    def jloss(p, z):
        z = z.at[:, 0].set(0.0)
        h = jax.nn.gelu(z @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(B), labels])

    def tloss(p, z):
        z = torch.cat([torch.zeros_like(z[:, :1]), z[:, 1:]], dim=1)
        h = torch.nn.functional.gelu(z @ p["w1"] + p["b1"], approximate="tanh")
        return torch.nn.functional.cross_entropy(h @ p["w2"] + p["b2"],
                                                 torch.as_tensor(labels))

    key = jax.random.PRNGKey(3)
    jx = jnp.asarray(x)
    jfns = {
        "jacobian": lambda p: jmod.jacobian_reg(lambda z: jloss(p, z), jx, key),
        "cure": lambda p: jmod.cure_reg(lambda z: jloss(p, z), jx),
        "curvature": lambda p: jmod.curvature_reg(lambda z: jloss(p, z), jx, key, iters=5),
    }
    ju = np.asarray(jax.random.normal(key, x.shape))  # the JAX functions' draw from key
    tx = torch.tensor(x)
    tfns = {
        "jacobian": lambda p: trob.jacobian_reg(lambda z: tloss(p, z), tx, 0,
                                                direction=torch.tensor(ju)),
        "cure": lambda p: trob.cure_reg(lambda z: tloss(p, z), tx),
        "curvature": lambda p: trob.curvature_reg(lambda z: tloss(p, z), tx, 0, iters=5,
                                                  direction=torch.tensor(ju)),
    }
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    errs, extra = {}, {}
    for name in jfns:
        jval, jgrad = jax.value_and_grad(jfns[name])(jp)
        tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        tval = tfns[name](tp)
        tg = torch.autograd.grad(tval, list(tp.values()))
        errs[f"{name}_value"] = abs(float(tval.detach()) - float(jval))
        errs[f"{name}_grad"] = max(float(np.abs(g.numpy() - np.asarray(jgrad[k])).max())
                                   for k, g in zip(tp, tg))
        extra[f"{name}_value"] = float(jval)
    # CURE sees sign(0) = 0 on feature 0 (its input gradient is exactly 0)
    g0 = jax.grad(lambda z: jloss(jp, z))(jx)[:, 0]
    extra["cure_zero_signs"] = int(np.sum(np.asarray(g0) == 0.0))
    moved = min(abs(v) for k, v in extra.items() if k.endswith("_value"))
    return errs, moved, extra, REG_TOL


# ---------------------------------------------------------------------------
# the robust program
# ---------------------------------------------------------------------------


def _jax_keyed_directions(names, counts):
    """The port's step seed of each (problem, count) -> the JAX step key of
    the same problem and count: JAX's ``jacobian_reg`` draws
    ``normal(key, x.shape)`` from the evaluating problem's step key."""
    keys = {}
    for name in names:
        seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
        for n in range(1, counts + 2):
            keys[fold_in(seed, n)] = jax.random.fold_in(jax.random.PRNGKey(seed), n)

    def directions(rng, x):
        return torch.tensor(np.asarray(jax.random.normal(keys[int(rng)], tuple(x.shape),
                                                         jnp.float64)))

    return directions


def _robust_engines(argv):
    jmod = load("robust_program_parity", "robust_nas/main.py")
    targs = trob.parse_args(argv + ["--device", "cpu"])
    teng = trob.build_engine(targs)
    _f64_port(teng)
    clf = teng.states["classifier"]
    if targs.arch == "mlp":
        net = trob.MixMLP()
    else:
        net = DARTSNetwork(channels=targs.channels, layers=targs.layers)
    variables = to_flax(net, clf["params"], clf["extra"].get("batch_stats", {}))
    if not variables["batch_stats"]:
        variables = {"params": variables["params"]}
    from_flax = jmod.from_flax
    jmod.from_flax = lambda module, *a, **kw: from_flax(module, *a, variables=variables, **kw)
    jeng = jmod.build_engine(targs)
    st = dict(jeng.states["arch"])
    st["params"] = {k: t.numpy() for k, t in teng.states["arch"]["params"].items()}
    jeng.states["arch"] = st
    _f64_jax(jeng)
    teng.classifier.directions = _jax_keyed_directions(("arch", "classifier"),
                                                       targs.train_iters)
    return jeng, teng, net


def _robust_errs(jeng, teng, net):
    jc = _np(jeng.states["classifier"])
    params, stats = convert.from_flax_darts(
        {"params": jc["params"], "batch_stats": jc["extra"].get("batch_stats", {})}, net,
        dtype=torch.float64)
    got = teng.states["classifier"]
    assert set(got["params"]) == set(params)
    alphas = convert.from_flax_alphas(_np(jeng.states["arch"]["params"]), dtype=torch.float64)
    errs = {"params": _max_err(params, got["params"]),
            "alphas": _max_err(alphas, teng.states["arch"]["params"])}
    if stats:
        errs["batch_stats"] = _max_err(stats, got["extra"]["batch_stats"])
    return errs


def _robust_case(argv, periods):
    jeng, teng, net = _robust_engines(argv + ["--train_iters", str(periods)])
    init = {k: t.clone() for k, t in teng.states["arch"]["params"].items()}
    jeng.run()
    teng.run()
    counts = {p.name: p.count for p in teng.problems}
    assert counts == {p.name: p.count for p in jeng.problems} == {
        "arch": periods, "classifier": periods}, counts
    errs = _robust_errs(jeng, teng, net)
    moved = _max_err(init, teng.states["arch"]["params"])
    return errs, moved, {"periods": periods}, TOL


def case_mlp():
    return _robust_case(ROBUST_ARGV + ["--arch", "mlp"], MLP_PERIODS)


DARTS_ARGV = ["--batch_size", "2", "--train_size", "8", "--valid_step", "1000", "--channels", "2",
              "--layers", "1", "--train_iters", "1"]


def _darts_loss_case(term):
    """The classifier's regularized loss with one term on (``term``), its
    gradient to the supernet's parameters and to the alphas, and the
    running statistics its first forward keeps, at the first step's seed
    on the classifier's first batch."""
    from betty_tpu.problems.problem import ctx_replace as jreplace
    from betty_tpu_torch.utils import value_and_grad

    off = "--lambda_c" if term == "jacobian" else "--lambda_j"
    jeng, teng, net = _robust_engines(DARTS_ARGV + [off, "0"])
    arrays = teng.classifier.train_data_loader[0].arrays
    x, y = np.asarray(arrays[0][:2], np.float64), np.asarray(arrays[1][:2])
    seed = zlib.crc32(b"classifier") & 0x7FFFFFFF

    jctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in jeng.states.items()}
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)

    def jloss(w, a):
        c = jreplace(jreplace(jctx, "classifier", w), "arch", a)
        loss, loss_dict, mutated = jeng.classifier.eval_loss(c, jbatch, rng=key, capture=True)
        return loss, (mutated, loss_dict["ce"])

    (jl, (jmut, jce)), (jw, ja) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jctx["classifier"]["params"], jctx["arch"]["params"])

    tctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in teng.states.items()}
    tbatch = (torch.tensor(x), torch.tensor(y).long())

    def tloss(w, a):
        c = ctx_replace(ctx_replace(tctx, "classifier", w), "arch", a)
        loss, _, mutated = teng.classifier.eval_loss(c, tbatch, rng=fold_in(seed, 1),
                                                     capture=True)
        return loss, mutated

    (tl, tmut), (tw, ta) = value_and_grad(tloss, tctx["classifier"]["params"],
                                          tctx["arch"]["params"], argnums=(0, 1),
                                          has_aux=True)
    want_w, want_stats = convert.from_flax_darts(
        {"params": _np(jw), "batch_stats": _np(jmut["batch_stats"])}, net, dtype=torch.float64)
    want_a = convert.from_flax_alphas(_np(ja), dtype=torch.float64)
    errs = {"loss": abs(float(tl) - float(jl)), "param_grad": _max_err(want_w, tw),
            "alpha_grad": _max_err(want_a, ta),
            "batch_stats": _max_err(want_stats, tmut["batch_stats"])}
    ce = float(jce)
    scale = max(float(t.abs().max()) for t in want_a.values())
    return errs, abs(float(jl) - ce), {"term": term, "ce": ce, "alpha_grad_scale": scale}, TOL


def case_darts_jacobian():
    return _darts_loss_case("jacobian")


def case_darts_cure():
    return _darts_loss_case("cure")


# ---------------------------------------------------------------------------
# the 4-level saliency-aware NAS
# ---------------------------------------------------------------------------


def _f64_data(mod):
    make = mod.make_data
    mod.make_data = lambda *a: (lambda x, y: (x.astype(np.float64), y))(*make(*a))


def _sanas_engines(spec):
    jmod = load("sanas_parity", "saliency_aware_nas_4_level/main.py")
    _f64_data(jmod)
    _f64_data(tsanas)
    targs = tsanas.parse_args(["--device", "cpu"] + [f"--{k}={v}" for k, v in spec.items()])
    teng = tsanas.build_engine(targs)
    teng.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                           else t, teng.states)
    net = MLP(spec["dim"], [64, spec["classes"]])
    variables = to_flax(net, teng.states["inner1"]["params"], {})
    from_flax = jmod.from_flax
    jmod.from_flax = lambda module, *a, **kw: from_flax(
        module, *a, variables={"params": variables["params"]}, **kw)
    jeng = jmod.build_engine(type("A", (), dict(spec)))
    return jmod, jeng, teng


def _sanas_errs(jeng, teng):
    errs = {}
    for name in ("outer", "inner2"):
        want = _t(_np(jeng.states[name]["params"]))
        errs[name] = _max_err(want, teng.states[name]["params"])
    want = convert.from_flax_mlp(_np(jeng.states["inner1"]["params"]), dtype=torch.float64)
    errs["inner1"] = _max_err(want, teng.states["inner1"]["params"])
    return errs


def case_sanas():
    _, jeng, teng = _sanas_engines(SANAS)
    init = {n: {k: t.clone() for k, t in s["params"].items()} for n, s in teng.states.items()}
    jeng.run()
    teng.run()
    counts = [p.count for p in teng.problems]
    assert counts == [p.count for p in jeng.problems] == [2, 4, 8], counts
    paths = [[q.name for q in path] for path in teng.outer.paths]
    assert paths == [[q.name for q in path] for path in jeng.outer.paths], paths
    assert len(paths) == 3, paths
    errs = _sanas_errs(jeng, teng)
    moved = min(_max_err(init[n], teng.states[n]["params"]) for n in init)
    return errs, moved, {"counts": counts, "paths": paths}, TOL


def case_budget():
    """The budget's gradient of the inner2 loss after one step, both
    packages at JAX's state and batch."""
    _, jeng, teng = _sanas_engines(BUDGET)
    jeng.run()
    teng.run()
    errs = _sanas_errs(jeng, teng)
    jctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in jeng.states.items()}
    jbatch = jeng.inner2.cur_batch

    def jloss(eps_params):
        c = dict(jctx)
        c["inner2"] = {"params": eps_params, "extra": jctx["inner2"]["extra"]}
        return jeng.inner2.eval_loss(c, jbatch, rng=jax.random.PRNGKey(0))[0]

    jg = np.asarray(jax.grad(jloss)(jctx["inner2"]["params"])["eps"])
    tctx = {n: {"params": (convert.from_flax_mlp(_np(s["params"]), dtype=torch.float64)
                           if n == "inner1" else _t(_np(s["params"]))), "extra": {}}
            for n, s in jeng.states.items()}
    tbatch = tuple(torch.tensor(np.array(a)) for a in jbatch)
    tbatch = (tbatch[0], tbatch[1].long())

    def tloss(eps_params):
        return teng.inner2.eval_loss(ctx_replace(tctx, "inner2", eps_params), tbatch, rng=0)[0]

    tg = tgrad(tloss)(tctx["inner2"]["params"])["eps"].numpy()
    errs["budget_grad"] = float(np.abs(tg - jg).max())

    # the ties: elements of the final delta at +-eps, and torch.clamp's gradient
    eps = tsanas.softplus(tctx["inner2"]["params"]["eps"]).detach()
    pgd = _pgd_delta(teng, tctx, tbatch)
    ties = int((pgd.abs() == eps.expand_as(pgd)).sum())
    saved = tsanas.project
    tsanas.project = lambda d, e: torch.clamp(d, -e, e)
    try:
        clamp_g = tgrad(tloss)(tctx["inner2"]["params"])["eps"].numpy()
    finally:
        tsanas.project = saved
    extra = {"ties": ties, "elements": int(pgd.numel()),
             "clamp_grad_err": float(np.abs(clamp_g - jg).max()),
             "grad_std": float(np.std(jg))}
    ok_extra = ties > 0 and extra["clamp_grad_err"] > 1e-6 and extra["grad_std"] > 1e-9
    return errs, float(np.abs(jg).max()), {**extra, "ties_matter": ok_extra}, REG_TOL


def _pgd_delta(teng, ctx, batch):
    """The inner2 loss's attack result at ``ctx``, before its final
    projection."""
    from betty_tpu_torch.problems.problem import _CtxBinding

    inner2 = teng.inner2
    x, y = batch
    with _CtxBinding(ctx, None, 0):
        mask = torch.sigmoid(inner2.outer())
        eps = tsanas.softplus(inner2.module())
        return tsanas.pgd_attack(
            lambda d: torch.nn.functional.cross_entropy(inner2.inner1((x + d) * mask), y), x,
            eps, inner2.cfg["pgd_steps"], inner2.cfg["pgd_lr"])


CASES = {"regularizers": case_regularizers, "mlp": case_mlp,
         "darts_jacobian": case_darts_jacobian, "darts_cure": case_darts_cure,
         "sanas": case_sanas, "budget": case_budget}


def main(cases):
    failed = []
    for case in cases:
        errs, moved, extra, tol = CASES[case]()
        ok = max(errs.values()) <= tol and moved > 0 and extra.get("ties_matter", True)
        print(("OK " if ok else "FAIL ") + json.dumps({"case": case, "max_abs_err": errs,
                                                     "tol": tol, "moved": moved, **extra}),
              flush=True)
        if not ok:
            failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
