"""Tutorial 8: a custom hypergradient solver (``tutorial/8_custom_solver.py``).

A solver computes, for one edge (``curr`` the lower problem, ``prev`` the
upper) of a backprop path, ``v' = (d w*(lambda) / d lambda)^T v``, where
``w*`` is the lower problem's best response to the upper parameters. The
port's solvers are functions over the context of parameters, so they
compose with ``torch.func`` and with compiled blocks:

    def my_solver(vector, curr, prev, ctx, states, curr_batch, rng):
        vector      v (a tree matching curr's params)
        curr/prev   Problem objects (config, eval_loss, paths)
        ctx         {problem_name: {"params": ..., "extra": ...}}
        states      the engine's states (optimizer moments: SAMA reads Adam's)
        curr_batch  curr's current batch
        rng         the step's integer seed
        returns     v' (a tree matching prev's params)

Register it once with ``register_solver("t1t2", my_solver)`` and choose it
per problem with ``Config(type="t1t2")``.

Below: the T1-T2 solver (one-step unrolled differentiation), the exact
mixed second derivative ``-(d^2 C / d lambda d w) v`` that darts
approximates by central differences: ``torch.func.jvp`` of
``torch.func.grad``, one forward-over-reverse pass.

    python -m betty_tpu_torch.tutorial.8_custom_solver            # on cuda
    python -m betty_tpu_torch.tutorial.8_custom_solver --device cpu
"""

import argparse

import torch

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.hypergradient import register_solver
from betty_tpu_torch.problems.problem import ctx_replace
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import neg, require_device


def t1t2(vector, curr, prev, ctx, states, curr_batch, rng):
    """Exact cross-Hessian-vector product ``-(d^2 C / d prev d curr) v``."""

    def grad_wrt_prev(curr_params):
        def loss(prev_params):
            c = ctx_replace(ctx, curr.name, curr_params)
            c = ctx_replace(c, prev.name, prev_params)
            return curr.eval_loss(c, curr_batch, rng=rng)[0]

        return torch.func.grad(loss)(ctx[prev.name]["params"])

    _, cross = torch.func.jvp(grad_wrt_prev, (ctx[curr.name]["params"],), (vector,))
    return neg(cross)


register_solver("t1t2", t1t2)


def build_engine(args):
    device = require_device(args.device, "tutorial 8")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(128, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, batch_size=128, seed=0),
        config=Config(type="t1t2", unroll_steps=1),  # the custom solver
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(128, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, batch_size=128, seed=1),
        config=Config(),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def first_leaf_norm(engine):
    """The norm of the reweighter's first leaf in JAX's order (flax's
    ``Dense_0/bias``: the port's ``layers.0.bias``)."""
    return float(torch.linalg.vector_norm(
        engine.states["reweight"]["params"]["layers.0.bias"].double()))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    w = engine.states["reweight"]["params"]["layers.0.bias"]
    if not torch.isfinite(w).all():
        raise RuntimeError("the reweighter's parameters are not finite")
    print("custom t1t2 solver trained; reweighter first-leaf norm:", first_leaf_norm(engine))
    return engine


if __name__ == "__main__":
    main()
