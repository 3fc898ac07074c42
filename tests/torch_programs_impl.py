"""The 3-level image-captioning NAS (IUC), learning by ignoring (LBI) and
implicit MAML of the JAX package and the port's, in float64 from the same
weights on the same batches.

* ``sama_grouped``: SAMA's ``precondition_adam`` with a grouped Adam (a
  base StepLR schedule scaled per group, per-group betas and eps) after
  five steps, against JAX's, within 1e-10.
* ``lbi``: the LBI program at ``tests/test_examples.py``'s arguments
  (``features_lr`` 0.08, ``classifier_lr`` 0.02), 4 iterations: every
  problem's parameters within 1e-8, counts 4:4:4, 2 paths into
  ``reweight``.
* ``captioner``: the ``Captioner`` (d 16, depth 1, 2 heads) with JAX's
  weights and projection: logits, ``caption_loss`` and its gradients to
  every parameter within 1e-10, and ``greedy_decode``'s tokens equal.
* ``iuc``: the IUC program at ``tests/test_examples2.py``'s arguments for
  8 inner1 steps: parameters within 1e-8, counts 8:4:2, 3 paths, every
  level moved, validation metrics equal.
* ``omniglot``: ``OmniglotCNN`` against flax's in float32 (1e-5) and
  float64 (1e-10): train-mode logits and new BatchNorm statistics, and
  eval-mode logits on them.
* ``imaml``: the iMAML program at ``tests/test_examples.py``'s arguments
  (3-way 1-shot, 2 inner steps, meta batch 2, 8 iterations): parameters
  and statistics within 1e-8, counts inner 8 and meta 4, an accumulation
  boundary at the end.
* ``imaml_pool``: the program on a synthetic Omniglot npz (class-disjoint
  pools), 4 iterations, then ``meta_test_acc`` equal to JAX's.

Run as a subprocess by the tests (float64 JAX must not leak into the
float32 test process):

    python tests/torch_programs_impl.py sama_grouped lbi captioner iuc omniglot imaml imaml_pool
"""

import json
import os
import sys
import tempfile
import types
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
from betty_tpu_torch.examples import implicit_maml as timaml  # noqa: E402
from betty_tpu_torch.examples import learning_by_ignoring as tlbi  # noqa: E402
from betty_tpu_torch.examples import nas_augmented_image_captioning_3_level as tiuc  # noqa: E402
from betty_tpu_torch.models.mlp import MLP  # noqa: E402
from betty_tpu_torch.utils import tree_map  # noqa: E402
from torch_darts_common import to_flax, write_pool  # noqa: E402
from torch_nas_impl import _max_err, load  # noqa: E402

TOL = 1e-8
MODEL_TOL = 1e-10
LBI = dict(dim=16, classes=3, n_source=128, n_target=128, batch=32, lr=0.05, features_lr=0.08,
           classifier_lr=0.02, meta_lr=0.01, rho=0.1, train_iters=4, log_step=-1,
           valid_step=1000)
IUC = ["--n", "128", "--batch", "16", "--seq_len", "8", "--vocab", "32", "--feat_dim", "16",
       "--dim", "32", "--depth", "1", "--heads", "2", "--unroll1", "2", "--unroll2", "2",
       "--train_iters", "8", "--valid_step", "1000"]
IMAML = dict(ways=3, shots=1, inner_steps=2, meta_batch_size=2, inner_lr=0.1, meta_lr=1e-3,
             reg=2.0, train_iters=8, seed=0, log_step=-1, valid_step=1000, eval_tasks=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jf64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if getattr(a, "dtype", None) == jnp.float32 else a, tree)


def _tf64(tree):
    return tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                    else t, tree)


def _argv(spec):
    return ["--device", "cpu"] + [f"--{k}={v}" for k, v in spec.items()]


def _moved(before, states):
    return min(_max_err(before[n], states[n]["params"]) for n in before)


def _params0(engine):
    return {n: {k: t.clone() for k, t in s["params"].items()} for n, s in engine.states.items()}


# ---------------------------------------------------------------------------
# grouped optimizers: SAMA's preconditioning
# ---------------------------------------------------------------------------


def case_sama_grouped():
    from betty_tpu import optim as jopt
    from betty_tpu.hypergradient.sama import precondition_adam as jprec
    from betty_tpu_torch import optim as topt
    from betty_tpu_torch.hypergradient.sama import precondition_adam as tprec

    rng = np.random.RandomState(0)
    p0 = {"feat": {"w": rng.randn(5, 3)}, "fc": {"w": rng.randn(3), "b": rng.randn(2)}}

    def groups():
        return [{"select": r"^feat", "lr": 0.1, "betas": (0.8, 0.99)},
                {"select": None, "eps": 1e-6}]

    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.tensor, p0)
    jg = jopt.grouped(jopt.adam(lr=0.01, schedule=jopt.step_lr(0.01, 2, 0.5)), groups(), jp)
    tg = topt.grouped(topt.adam(lr=0.01, schedule=topt.step_lr(0.01, 2, 0.5)), groups(), tp)
    js, ts = jg.init(jp), tg.init(tp)
    for step in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape), p0)
        ju, js = jg.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, sched_step=step)
        tu, ts = tg.update(tree_map(torch.tensor, g), ts, tp, sched_step=step)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tp = tree_map(torch.add, tp, tu)
    vec = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape), p0)
    jv = jprec(jax.tree_util.tree_map(jnp.asarray, vec), types.SimpleNamespace(optimizer=jg),
               {"opt_state": js, "last_grad": jax.tree_util.tree_map(jnp.asarray, g),
                "sched_step": 5})
    tv = tprec(tree_map(torch.tensor, vec), types.SimpleNamespace(optimizer=tg),
               {"opt_state": ts, "last_grad": tree_map(torch.tensor, g), "sched_step": 5})
    errs = {}
    for k1 in p0:
        for k2 in p0[k1]:
            errs[f"{k1}/{k2}"] = float(np.abs(tv[k1][k2].numpy() - np.asarray(jv[k1][k2])).max())
            errs[f"param {k1}/{k2}"] = float(np.abs(tp[k1][k2].numpy()
                                                    - np.asarray(jp[k1][k2])).max())
    lrs = [float(x) for x in (tv["feat"]["w"].abs().max(), tv["fc"]["w"].abs().max())]
    return errs, min(lrs), {}, MODEL_TOL


# ---------------------------------------------------------------------------
# learning by ignoring
# ---------------------------------------------------------------------------


def _f64_domain(mod):
    make = mod.make_domain
    mod.make_domain = lambda *a, **kw: (lambda x, y: (x.astype(np.float64), y))(*make(*a, **kw))


def case_lbi():
    jmod = load("lbi_parity", "learning_by_ignoring/main.py")
    _f64_domain(jmod)
    _f64_domain(tlbi)
    teng = tlbi.build_engine(tlbi.parse_args(_argv(LBI)))
    teng.states = _tf64(teng.states)
    net = MLP(LBI["dim"], [64, LBI["classes"]])
    weights = iter([to_flax(net, teng.states[n]["params"], {}) for n in ("pretrain", "finetune")])
    from_flax = jmod.from_flax
    jmod.from_flax = lambda module, *a, **kw: from_flax(
        module, *a, variables={"params": next(weights)["params"]}, **kw)
    jeng = jmod.build_engine(types.SimpleNamespace(**LBI))
    jeng.states = _jf64(jeng.states)
    init = _params0(teng)
    jeng.run()
    teng.run()
    counts = [p.count for p in teng.problems]
    assert counts == [p.count for p in jeng.problems] == [4, 4, 4], counts
    paths = [[q.name for q in path] for path in teng.reweight.paths]
    assert paths == [[q.name for q in path] for path in jeng.reweight.paths], paths
    assert len(paths) == 2, paths
    assert [len(g) for g in teng.finetune.optimizer.group_meta] and \
        [m["lr"] for m in teng.finetune.optimizer.group_meta] == [0.08, 0.02]
    errs = {"reweight": _max_err(_t(_np(jeng.states["reweight"]["params"])),
                                 teng.states["reweight"]["params"])}
    for name in ("pretrain", "finetune"):
        want = convert.from_flax_mlp(_np(jeng.states[name]["params"]), dtype=torch.float64)
        errs[name] = _max_err(want, teng.states[name]["params"])
    return errs, _moved(init, teng.states), {"counts": counts, "paths": paths}, TOL


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the image-captioning NAS
# ---------------------------------------------------------------------------


def _jax_proj(feat_dim, mem_tokens, dim):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1234), (feat_dim, mem_tokens * dim)))


def case_captioner():
    jmod = load("iuc_model", "nas_augmented_image_captioning_3_level/main.py")
    from betty_tpu_torch.models.iuc import Captioner

    V, F_, D, L = 32, 16, 16, 8
    rng = np.random.RandomState(0)
    feats, alphas = rng.randn(4, F_), rng.randn(2)
    caps = rng.randint(3, V, (4, L))
    caps[:, 0] = 1
    caps[:2, 5:] = 0  # PAD tails: the loss masks them
    jm = jmod.Captioner(vocab=V, dim=D, depth=1, heads=2, max_len=L)
    variables = _jf64(jm.init(jax.random.PRNGKey(0), jnp.zeros((4, F_)), jnp.zeros(2),
                              jnp.zeros((4, L - 1), jnp.int32)))
    params, proj = convert.from_flax_captioner(_np(variables["params"]),
                                               proj=_jax_proj(F_, 4, D), dtype=torch.float64)
    tm = Captioner(V, F_, dim=D, depth=1, heads=2, max_len=L)
    tm.proj = proj

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(feats), jnp.asarray(alphas),
                          jnp.asarray(caps[:, :-1]))
        return jmod.caption_loss(logits, jnp.asarray(caps[:, 1:])), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tparams = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    targs = (torch.tensor(feats), torch.tensor(alphas))
    tlogits = torch.func.functional_call(tm, tparams, (*targs, torch.tensor(caps[:, :-1])))
    tl = tiuc.caption_loss(tlogits, torch.tensor(caps[:, 1:]))
    tg = torch.autograd.grad(tl, list(tparams.values()))
    want_g, _ = convert.from_flax_captioner(_np(jg), dtype=torch.float64)
    errs = {"logits": float(np.abs(tlogits.detach().numpy() - np.asarray(jlogits)).max()),
            "loss": abs(float(tl) - float(jl)),
            "grads": max(float((g - want_g[k]).abs().max()) for k, g in zip(tparams, tg))}
    jdec = np.asarray(jmod.greedy_decode(jm.apply, variables, jnp.asarray(feats),
                                         jnp.asarray(alphas), L))
    tdec = tiuc.greedy_decode(
        lambda f, a, c: torch.func.functional_call(tm, params, (f, a, c)), *targs, L).numpy()
    same = bool((jdec == tdec).all())
    return errs, float(np.abs(np.asarray(jlogits)).max()), \
        {"decoded_equal": same, "ok_extra": same}, MODEL_TOL


def _f64_captions(mod):
    make = mod.make_caption_data
    mod.make_caption_data = lambda *a, **kw: (lambda f, c: (f.astype(np.float64), c))(
        *make(*a, **kw))


class _Recorded:
    """The port's ``Captioner`` instances an engine build makes."""

    def __init__(self):
        self.made = []
        base = tiuc.Captioner
        made = self.made

        class Captioner(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        tiuc.Captioner = Captioner


def case_iuc():
    jmod = load("iuc_parity", "nas_augmented_image_captioning_3_level/main.py")
    _f64_captions(jmod)
    _f64_captions(tiuc)
    jargs = jmod.parse_args(IUC)
    jeng = jmod.build_engine(jargs)
    jeng.states = _jf64(jeng.states)
    rec = _Recorded()
    teng = tiuc.build_engine(tiuc.parse_args(["--device", "cpu"] + IUC))
    teng.states = _tf64(teng.states)
    proj = torch.tensor(_jax_proj(jargs.feat_dim, 4, jargs.dim))
    for m in rec.made:
        m.proj = proj
    for name in ("inner1", "inner2"):
        st = dict(teng.states[name])
        st["params"], _ = convert.from_flax_captioner(_np(jeng.states[name]["params"]),
                                                      dtype=torch.float64)
        teng.states[name] = st
    init = _params0(teng)
    jeng.run()
    teng.run()
    counts = [p.count for p in teng.problems]
    assert counts == [p.count for p in jeng.problems] == [2, 4, 8], counts
    paths = [[q.name for q in path] for path in teng.outer.paths]
    assert paths == [[q.name for q in path] for path in jeng.outer.paths], paths
    assert len(paths) == 3, paths
    errs = {"outer": _max_err(_t(_np(jeng.states["outer"]["params"])),
                              teng.states["outer"]["params"])}
    for name in ("inner1", "inner2"):
        want, _ = convert.from_flax_captioner(_np(jeng.states[name]["params"]),
                                              dtype=torch.float64)
        errs[name] = _max_err(want, teng.states[name]["params"])
    jval, tval = jeng.validation(), teng.validation()
    moved = _moved(init, teng.states)
    return errs, moved, {"counts": counts, "paths": paths, "validation": tval,
                         "ok_extra": jval == tval}, TOL


# ---------------------------------------------------------------------------
# the Omniglot CNN and implicit MAML
# ---------------------------------------------------------------------------


def case_omniglot():
    """Errors as fractions of their tolerances (float32 1e-5, float64
    1e-10); the raw errors are reported beside them."""
    from betty_tpu.models.omniglot import OmniglotCNN as JCNN
    from betty_tpu_torch.models.omniglot import OmniglotCNN

    x = np.random.RandomState(0).randn(6, 28, 28, 1)
    raw, scaled, scale = {}, {}, 0.0
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                            (torch.float64, jnp.float64, MODEL_TOL)):
        jm = JCNN(num_classes=5)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
        # non-trivial running statistics for the eval-mode check
        v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
            lambda a: a + 0.1 * jnp.arange(a.shape[0]), v["batch_stats"])}
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v)
        xj = jnp.asarray(x, jdt)
        jlogits, mut = jm.apply(v, xj, train=True, mutable=["batch_stats"])
        jeval = jm.apply(v, xj, train=False)
        params, stats = convert.from_flax_omniglot(_np(v), dtype=dtype)
        want = convert.from_flax_omniglot(_np({"params": v["params"], **mut}), dtype=dtype)[1]
        tm = OmniglotCNN(num_classes=5)
        xt = torch.tensor(x, dtype=dtype)
        updates = {}
        tlogits = torch.func.functional_call(tm, {**params, **stats}, (xt,),
                                             {"train": True, "updates": updates})
        names = {m: n for n, m in tm.named_modules()}
        new = {f"{names[m]}.{b}": t for (m, b), t in updates.items()}
        teval = torch.func.functional_call(tm, {**params, **stats}, (xt,), {"train": False})
        key = str(dtype).split(".")[1]
        raw[f"{key} logits"] = float(np.abs(tlogits.detach().numpy() - np.asarray(jlogits)).max())
        raw[f"{key} stats"] = max(float((new[k] - want[k]).abs().max()) for k in want)
        raw[f"{key} eval"] = float(np.abs(teval.detach().numpy() - np.asarray(jeval)).max())
        scaled.update({k: e / tol for k, e in raw.items() if k.startswith(key)})
        scale = max(scale, float(np.abs(np.asarray(jlogits)).max()))
    return scaled, scale, {"raw": raw}, 1.0


def _f64_env(cls):
    step = cls.step

    def f64_step(self):
        step(self)
        self.support = (self.support[0].astype(np.float64), self.support[1])
        self.query = (self.query[0].astype(np.float64), self.query[1])

    cls.step = f64_step


def _imaml_engines(spec, data_dir=None):
    jmod = load("imaml_parity", "implicit_maml/main.py")
    _f64_env(jmod.MAMLEnv)
    _f64_env(timaml.MAMLEnv)
    spec = dict(spec, data_dir=data_dir)
    jeng = jmod.build_engine(types.SimpleNamespace(**spec))
    jeng.states = _jf64(jeng.states)
    argv = _argv({k: v for k, v in spec.items() if k != "data_dir"})
    teng = timaml.build_engine(timaml.parse_args(argv + (["--data-dir", data_dir]
                                                         if data_dir else [])))
    teng.states = _tf64(teng.states)
    for name in ("meta", "inner"):
        js = jeng.states[name]
        params, stats = convert.from_flax_omniglot(
            _np({"params": js["params"], **js["extra"]}), dtype=torch.float64)
        teng.states[name] = {**teng.states[name], "params": params,
                             "extra": {"batch_stats": stats}}
    return jeng, teng


def _imaml_errs(jeng, teng):
    errs = {}
    for name in ("meta", "inner"):
        js = jeng.states[name]
        params, stats = convert.from_flax_omniglot(
            _np({"params": js["params"], **js["extra"]}), dtype=torch.float64)
        errs[name] = _max_err(params, teng.states[name]["params"])
        errs[f"{name} stats"] = _max_err(stats, teng.states[name]["extra"]["batch_stats"])
    return errs


def case_imaml():
    jeng, teng = _imaml_engines(IMAML)
    init = _params0(teng)
    jeng.run()
    teng.run()
    counts = {"inner": teng.inner.count, "meta": teng.meta.count}
    assert counts == {"inner": jeng.inner.count, "meta": jeng.meta.count} == \
        {"inner": 8, "meta": 4}, counts
    boundary = teng.meta.gradient_accumulation_boundary()
    assert boundary and jeng.meta.gradient_accumulation_boundary()
    return _imaml_errs(jeng, teng), _moved(init, teng.states), {"counts": counts}, TOL


def case_imaml_pool():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "omniglot.npz")
        write_pool(path)
        jeng, teng = _imaml_engines(dict(IMAML, train_iters=4), data_dir=path)
        init = _params0(teng)
        jeng.run()
        teng.run()
        jacc, tacc = jeng.validation(), teng.validation()
    errs = _imaml_errs(jeng, teng)
    return errs, _moved(init, teng.states), {"validation": tacc, "jax": jacc,
                                             "ok_extra": jacc == tacc}, TOL


CASES = {"sama_grouped": case_sama_grouped, "lbi": case_lbi, "captioner": case_captioner,
         "iuc": case_iuc, "omniglot": case_omniglot, "imaml": case_imaml,
         "imaml_pool": case_imaml_pool}


def main(cases):
    failed = []
    for case in cases:
        errs, moved, extra, tol = CASES[case]()
        ok = max(errs.values()) <= tol and moved > 0 and extra.get("ok_extra", True)
        print(("OK " if ok else "FAIL ") + json.dumps({"case": case, "max_abs_err": errs,
                                                     "tol": tol, "moved": moved, **extra}),
              flush=True)
        if not ok:
            failed.append(case)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(CASES)))
