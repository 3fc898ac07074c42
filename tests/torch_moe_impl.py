"""The Switch MoE layer and its bilevel program, JAX package against the
port, in float64 from the same weights on the same inputs.

* ``layer``: ``moe_ffn`` at DIM 16 / HID 32 / E 4 / T 64 for capacities T,
  2 and the default (1.25), and ``moe_ffn_dense``: ``y`` and ``aux``
  within 1e-12, the gradients of every parameter and of ``x`` (of
  ``sum(y * g) + aux`` for a fixed random ``g``) within 1e-10.
* ``driver`` / ``compiled``: the program of ``tests/test_ep.py``'s
  unsharded run (an MoE FFN with a residual and a linear head under a
  Meta-Weight-Net, darts, unroll 2, every token to its expert), 4
  iterations; the port's ``examples/moe_reweighting.py --dense`` in driver
  mode and compiled, both problems' parameters within 1e-10 of JAX's.

Run as a subprocess by test_torch_moe.py (float64 JAX must not leak into
the float32 test process); prints one ``OK``/``FAIL`` JSON line a case.

    python tests/torch_moe_impl.py layer driver compiled
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from betty_tpu import Config, Engine, EngineConfig, ImplicitProblem, optim  # noqa: E402
from betty_tpu.models import MetaWeightNet  # noqa: E402
from betty_tpu.models import moe as jmoe  # noqa: E402
from betty_tpu.module import from_flax, from_fn  # noqa: E402
from betty_tpu_torch import convert  # noqa: E402
from betty_tpu_torch.examples import moe_reweighting as tex  # noqa: E402
from betty_tpu_torch.models import moe as tmoe  # noqa: E402
from betty_tpu_torch.utils import tree_leaves, tree_map  # noqa: E402

DIM, HID, E, T = 16, 32, 4, 64
LAYER_TOL, GRAD_TOL, PROGRAM_TOL = 1e-12, 1e-10, 1e-10
ITERS = 4


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def layer_case():
    jp = _f64(jmoe.init_moe_params(jax.random.PRNGKey(0), DIM, HID, E))
    rng = np.random.RandomState(1)
    x = rng.randn(T, DIM)
    g = rng.randn(T, DIM)
    tp = convert.from_jax_moe(jax.tree_util.tree_map(np.asarray, jp), dtype=torch.float64)
    errs = {}
    for cap in (T, 2, None, "dense"):
        def jfn(p, xx):
            if cap == "dense":
                return jmoe.moe_ffn_dense(p, xx)
            return jmoe.moe_ffn(p, xx, capacity=cap)

        def tfn(p, xx):
            if cap == "dense":
                return tmoe.moe_ffn_dense(p, xx)
            return tmoe.moe_ffn(p, xx, capacity=cap)

        yj, auxj = jfn(jp, jnp.asarray(x))
        (gpj, gxj) = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx)[0] * g) + jfn(p, xx)[1],
                              argnums=(0, 1))(jp, jnp.asarray(x))
        tp_ = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xt = torch.tensor(x, requires_grad=True)
        yt, auxt = tfn(tp_, xt)
        (torch.sum(yt * torch.tensor(g)) + auxt).backward()
        key = str(cap)
        errs[key] = {
            "y": float(np.abs(np.asarray(yj) - yt.detach().numpy()).max()),
            "aux": abs(float(auxj) - float(auxt.detach())),
            "grad": max([float(np.abs(np.asarray(gpj[k]) - tp_[k].grad.numpy()).max())
                         for k in tp] + [float(np.abs(np.asarray(gxj) - xt.grad.numpy()).max())]),
            "router_grad": float(np.abs(np.asarray(gpj["router"])).max()),
            "dropped": int(np.all(np.asarray(yj) == 0.0, axis=1).sum()),
        }
    ok = all(e["y"] <= LAYER_TOL and e["aux"] <= LAYER_TOL and e["grad"] <= GRAD_TOL
             and e["router_grad"] > 0 for e in errs.values())
    ok = ok and errs["2"]["dropped"] > 0 and errs[str(T)]["dropped"] == 0
    return ok, errs


def jax_program():
    """``tests/test_ep.py``'s program, unsharded, in float64 (its float32
    data and weights, cast)."""
    rng = np.random.RandomState(0)

    def f32(a):
        return jnp.asarray(np.asarray(a, np.float32), jnp.float64)

    x = f32(rng.randn(T, DIM))
    y = jnp.asarray(rng.randint(0, 2, T), jnp.int32)
    xv = f32(rng.randn(32, DIM))
    yv = jnp.asarray(rng.randint(0, 2, 32), jnp.int32)
    moe_p = _f64(jmoe.init_moe_params(jax.random.PRNGKey(0), DIM, HID, E))
    out_w = f32(0.1 * rng.randn(DIM, 2))

    def apply(p, inp):
        h, aux = jmoe.moe_ffn(p["moe"], inp, capacity=inp.shape[0])
        return (inp + h) @ p["out"], aux

    class Inner(ImplicitProblem):
        def training_step(self, batch):
            bx, by = batch
            logits, aux = self.module(bx)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, by)
            w = self.outer(jax.lax.stop_gradient(ce))
            return jnp.mean(w * ce) + 0.01 * aux

    class Outer(ImplicitProblem):
        def training_step(self, batch):
            bx, by = batch
            logits, _ = self.inner(bx)
            return optax.softmax_cross_entropy_with_integer_labels(logits, by).mean()

    inner = Inner("inner", module=from_fn(apply, {"moe": moe_p, "out": out_w}),
                  optimizer=optim.sgd(lr=0.05), train_data_loader=[(x, y)],
                  config=Config(type="darts", unroll_steps=2))
    outer = Outer("outer", module=from_flax(MetaWeightNet(), jnp.zeros((8,)),
                                            rng=jax.random.PRNGKey(1), train_kwarg="train"),
                  optimizer=optim.adam(lr=1e-3), train_data_loader=[(xv, yv)], config=Config())
    eng = Engine(config=EngineConfig(train_iters=ITERS), problems=[outer, inner],
                 dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}})
    eng.states = _f64(eng.states)
    return eng


def port_params(jstates):
    inner = jax.tree_util.tree_map(np.asarray, jstates["inner"]["params"])
    return {
        "inner": {"moe": convert.from_jax_moe(inner["moe"], dtype=torch.float64),
                  "out": torch.tensor(inner["out"], dtype=torch.float64)},
        "outer": convert.from_flax_mwn(
            jax.tree_util.tree_map(np.asarray, jstates["outer"]["params"]), dtype=torch.float64),
    }


def program_case(compiled):
    jeng = jax_program()
    init = port_params(jeng.states)
    argv = ["--device", "cpu", "--dim", str(DIM), "--hidden", str(HID), "--experts", str(E),
            "--tokens", str(T), "--val_tokens", "32", "--dense", "--train_iters", str(ITERS)]
    teng = tex.build_engine(tex.parse_args(argv + (["--compile_blocks"] if compiled else [])))
    teng.config.block_periods = 1
    teng.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                           else t, teng.states)
    for name in ("inner", "outer"):
        teng.states[name]["params"] = tree_map(torch.clone, init[name])
    for p in teng.problems:
        (xb, yb), = p.train_data_loader[0]
        p.train_data_loader[0][0] = (xb.double(), yb)
    # the port draws its data in the JAX test's order: the batches must agree
    jinner = jeng.inner.train_data_loader[0][0]
    assert np.array_equal(np.asarray(jinner[0]), teng.inner.train_data_loader[0][0][0].numpy())
    jeng.run()
    teng.run()
    want = port_params(jeng.states)
    errs = {n: max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(teng.states[n]["params"]), tree_leaves(want[n])))
            for n in want}
    moved = {n: max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(want[n]), tree_leaves(init[n]))) for n in want}
    counts = [p.count for p in teng.problems], [p.count for p in jeng.problems]
    ok = max(errs.values()) <= PROGRAM_TOL and min(moved.values()) > 0 and counts[0] == counts[1]
    if compiled:
        runner = teng.block_runner
        ok = ok and runner is not None and runner.periods_run >= 1
    return ok, {"max_abs_err": errs, "moved": moved, "counts": counts}


CASES = {"layer": layer_case, "driver": lambda: program_case(False),
         "compiled": lambda: program_case(True)}


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
