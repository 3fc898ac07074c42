"""Bilevel logistic-regression hyperparameter optimization.

Port of ``examples/logistic_regression_hpo/main.py``: the outer problem
learns a per-parameter weight-decay vector; the inner problem fits logistic
regression under that penalty. The solver is cg, darts or neumann, with
``unroll_steps=100``, the inner weights reset to zero at the start of each
unroll (``on_inner_loop_start``) and the outer weights clamped to at least
1e-8 after each step (``param_callback``). ``--compile_blocks`` runs it as
compiled blocks.

    python -m betty_tpu_torch.examples.logistic_regression_hpo --solver cg --device cpu
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.module import from_fn
from betty_tpu_torch.utils import tree_map


def make_data(seed=0, n=1000, dim=20):
    """Train and validation halves of a noisy linearly separable set (the
    JAX example's generator, draw for draw), as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    w_gt = rng.randn(dim)
    x = rng.randn(n, dim)
    y = ((x @ w_gt + 0.1 * rng.randn(n)) > 0).astype(np.float32)
    half = n // 2
    return ((x[:half].astype(np.float32), y[:half]),
            (x[half:].astype(np.float32), y[half:]))


def bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)


class Outer(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        outs = self.inner(inputs)[0]
        loss = bce(outs, targets)
        acc = ((outs > 0) == (targets > 0.5)).float().mean() * 100
        return {"loss": loss, "acc": acc}

    def param_callback(self):
        self.set_params(tree_map(lambda p: torch.clamp(p, min=1e-8), self.params))


class Inner(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        outs, params = self.module(inputs)
        reg = 0.5 * torch.sum(self.outer() * params * params)
        return bce(outs, targets) + reg

    def on_inner_loop_start(self):
        self.set_params(tree_map(torch.zeros_like, self.params))


SOLVER_CONFIGS = {
    "cg": dict(type="cg", cg_iterations=3, cg_alpha=1.0),
    "darts": dict(type="darts"),
    "neumann": dict(type="neumann", neumann_iterations=3),
}


def build_engine(args, inner_config=None):
    """``(engine, outer)``; ``inner_config`` replaces the inner problem's
    ``Config`` built from ``--solver``."""
    train, valid = make_data(seed=args.seed, dim=args.dim)
    device = torch.device(args.device)
    if inner_config is None:
        inner_config = Config(unroll_steps=args.unroll_steps, **SOLVER_CONFIGS[args.solver])
    outer = Outer(
        name="outer",
        module=from_fn(lambda p: p["w"], {"w": torch.ones(args.dim, device=device)}),
        optimizer=optim.sgd(lr=args.outer_lr, momentum=0.9),
        train_data_loader=[valid],
        config=Config(log_step=args.log_step, retain_graph=True),
    )
    inner = Inner(
        name="inner",
        module=from_fn(lambda p, x: (x @ p["w"], p["w"]),
                       {"w": torch.zeros(args.dim, device=device)}),
        optimizer=optim.sgd(lr=args.inner_lr),
        train_data_loader=[train],
        config=inner_config,
    )
    engine = Engine(
        config=EngineConfig(train_iters=args.train_iters, compile_blocks=args.compile_blocks),
        problems=[outer, inner],
        dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
        device=device,
    )
    return engine, outer


def final_outer_loss(engine, outer):
    """The outer loss at the final parameters on the outer's last batch."""
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    return float(outer.eval_loss(ctx, outer.cur_batch)[0])


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--solver", default="cg", choices=sorted(SOLVER_CONFIGS))
    p.add_argument("--train_iters", type=int, default=2000)
    p.add_argument("--unroll_steps", type=int, default=100)
    p.add_argument("--inner_lr", type=float, default=0.1)
    p.add_argument("--outer_lr", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


if __name__ == "__main__":
    engine, outer = build_engine(parse_args())
    engine.run()
    print(f"final outer loss: {final_outer_loss(engine, outer):.4f}")
