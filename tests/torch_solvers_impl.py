"""darts, SAMA, CG and Neumann hypergradients of the port against betty_tpu
and against the float64 torch-autograd references of golden_impl.py, on
golden_impl's bilevel logistic-regression fixture. CG and Neumann run in
both ``hvp_mode``s, with and without ``use_fused_vector_ops``. Run as a
subprocess by test_torch_solvers.py (float64 JAX must not leak into the
float32 test process). Required agreement: 1e-10 in float64.

The JAX package's fused path ravels to float32 even under float64, so the
port's fused path (whose ravel keeps float64) is held against the JAX tree
path of the same ``hvp_mode``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden_impl as g  # noqa: E402  (enables float64 in JAX and torch)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from betty_tpu import optim as joptim  # noqa: E402
from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim  # noqa: E402
from betty_tpu_torch.hypergradient import (  # noqa: E402
    cg, compute_path_grads, darts, neumann, sama)
from betty_tpu_torch.module import from_fn  # noqa: E402
from betty_tpu_torch.problems.problem import ctx_replace  # noqa: E402
from betty_tpu_torch.utils import grad  # noqa: E402

TOL = 1e-10
Config_j = g.Config  # betty_tpu's Config (the port's is imported as Config)


def bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)


class Outer(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        return bce(self.inner(inputs)[0], targets)


class Inner(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        outs, params = self.module(inputs)
        return bce(outs, targets) + 0.5 * torch.sum(self.outer() * params * params)


def build_port(inner_config, inner_optimizer):
    t = torch.as_tensor
    outer = Outer("outer", module=from_fn(lambda p: p["w"], {"w": t(g.LAM0)}),
                  optimizer=optim.sgd(lr=1.0), train_data_loader=[(t(g.XV), t(g.YV))],
                  config=Config())
    inner = Inner("inner", module=from_fn(lambda p, i: (i @ p["w"], p["w"]), {"w": t(g.W0)}),
                  optimizer=inner_optimizer, train_data_loader=[(t(g.X), t(g.Y))],
                  config=inner_config)
    engine = Engine(config=EngineConfig(train_iters=1), problems=[outer, inner],
                    dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                    device="cpu")
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    return engine, outer, inner, ctx, (t(g.X), t(g.Y))


def port_direct_v(outer, ctx):
    def loss(wp):
        c = ctx_replace(ctx, "inner", wp)
        return outer.eval_loss(c, (torch.as_tensor(g.XV), torch.as_tensor(g.YV)))[0]

    return grad(loss)(ctx["inner"]["params"])


def check(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    ok = err <= TOL
    print(f"{'OK ' if ok else 'FAIL'} {name}: max|diff| = {err:.3e}")
    return ok


def main():
    ok = True
    key = jax.random.PRNGKey(0)

    # direct gradient and darts
    jeng, jout, jin, jctx, jbatch = g.build_jax(Config_j(type="darts", darts_alpha=0.01),
                                                joptim.sgd(lr=0.1))
    teng, tout, tin, tctx, tbatch = build_port(Config(type="darts", darts_alpha=0.01),
                                               optim.sgd(lr=0.1))
    jv = g.j_direct_v(jout, jin, jctx)
    tv = port_direct_v(tout, tctx)
    ok &= check("direct grad v vs betty_tpu", tv["w"], jv["w"])
    jd = g.jax_darts(jv, jin, jout, jctx, jeng.states, jbatch, key)
    td = darts(tv, tin, tout, tctx, teng.states, tbatch, 0)
    ok &= check("darts vs betty_tpu", td["w"], jd["w"])
    ok &= check("darts vs torch autograd", td["w"], g.t_darts(torch.as_tensor(tv["w"])))
    # the same hypergradient through the outer problem's path
    tout.cur_batch = (torch.as_tensor(g.XV), torch.as_tensor(g.YV))
    tin.cur_batch = tbatch
    hyper = compute_path_grads(tout, tctx, teng.states, tout.cur_batch, {"inner": tbatch}, 0,
                               1.0)
    ok &= check("compute_path_grads(darts) vs darts", hyper["w"], td["w"])

    # sama, with known Adam moments and last gradient injected into the state
    rng = np.random.RandomState(7)
    mu = 0.1 * rng.randn(g.D)
    nu = np.abs(rng.randn(g.D)) * 0.01 + 1e-4
    lg = 0.2 * rng.randn(g.D)
    jeng, jout, jin, jctx, jbatch = g.build_jax(Config_j(type="sama", sama_adam_alpha=1.0),
                                                joptim.adam(lr=0.05))
    teng, tout, tin, tctx, tbatch = build_port(Config(type="sama", sama_adam_alpha=1.0),
                                               optim.adam(lr=0.05))
    st = dict(jeng.states["inner"])
    adam_state = joptim.find_adam_state(st["opt_state"])
    new_adam = adam_state._replace(mu={"w": jnp.asarray(mu)}, nu={"w": jnp.asarray(nu)})
    st["opt_state"] = tuple(new_adam if s is adam_state else s for s in st["opt_state"])
    st["last_grad"] = {"w": jnp.asarray(lg)}
    jeng.states["inner"] = st
    ts = dict(teng.states["inner"])
    ts["opt_state"] = {"count": 1, "mu": {"w": torch.as_tensor(mu)},
                       "nu": {"w": torch.as_tensor(nu)}}
    ts["last_grad"] = {"w": torch.as_tensor(lg)}
    teng.states["inner"] = ts

    jv = g.j_direct_v(jout, jin, jctx)
    tv = port_direct_v(tout, tctx)
    js = g.jax_sama(jv, jin, jout, jctx, jeng.states, jbatch, key)
    tsama = sama(tv, tin, tout, tctx, teng.states, tbatch, 0)
    ok &= check("sama vs betty_tpu", tsama["w"], js["w"])
    want = g.t_sama(torch.as_tensor(tv["w"]), torch.as_tensor(mu), torch.as_tensor(nu),
                    torch.as_tensor(lg))
    ok &= check("sama vs torch autograd", tsama["w"], want.detach())

    # cg and neumann: golden_impl's settings, both HVP constructions, tree
    # and fused vector loops
    solvers = (
        ("neumann", neumann, g.jax_neumann, g.t_neumann,
         dict(neumann_iterations=4, neumann_alpha=0.7)),
        ("cg", cg, g.jax_cg, g.t_cg, dict(cg_iterations=3, cg_alpha=0.35)),
    )
    for name, port_fn, jax_fn, torch_fn, extra in solvers:
        for hvp_mode in ("jvp", "vjp"):
            jeng, jout, jin, jctx, jbatch = g.build_jax(
                Config_j(type=name, hvp_mode=hvp_mode, **extra), joptim.sgd(lr=0.1))
            jv = g.j_direct_v(jout, jin, jctx)
            jres = jax_fn(jv, jin, jout, jctx, jeng.states, jbatch, key)
            for fused in (False, True):
                teng, tout, tin, tctx, tbatch = build_port(
                    Config(type=name, hvp_mode=hvp_mode, use_fused_vector_ops=fused, **extra),
                    optim.sgd(lr=0.1))
                tv = port_direct_v(tout, tctx)
                tres = port_fn(tv, tin, tout, tctx, teng.states, tbatch, 0)
                tag = f"{name}[{hvp_mode}{', fused' if fused else ''}]"
                ok &= check(f"{tag} vs betty_tpu", tres["w"], jres["w"])
                ok &= check(f"{tag} vs torch autograd", tres["w"],
                            torch_fn(torch.as_tensor(tv["w"])).detach())
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
