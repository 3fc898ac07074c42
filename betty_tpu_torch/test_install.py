"""Install check (``betty_tpu/test_install.py``): a self-contained bilevel
logistic-regression HPO with the CG solver (3 iterations, unroll 100) that
prints "Hello (Betty-TPU) World" when the final outer loss is below 0.48.

The outer problem learns a per-parameter weight-decay vector (clipped to at
least 1e-8 after each step); the inner problem fits logistic regression
under it, from zero weights at the start of each unroll. The data are the
JAX check's numpy draws.

    python -m betty_tpu_torch.test_install                 # on cuda
    python -m betty_tpu_torch.test_install --device cpu
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.module import from_fn
from betty_tpu_torch.utils import require_device, tree_map


def bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)


class Outer(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        return bce(self.inner(inputs)[0], targets)

    def param_callback(self):
        self.set_params(tree_map(lambda p: torch.clamp(p, min=1e-8), self.params))


class Inner(ImplicitProblem):
    def training_step(self, batch):
        inputs, targets = batch
        outs, params = self.module(inputs)
        return bce(outs, targets) + 0.5 * torch.sum(self.outer() * params * params)

    def on_inner_loop_start(self):
        self.set_params(tree_map(torch.zeros_like, self.params))


def build_engine(train_iters=2000, dim=20, seed=0, device=None):
    """``(engine, outer)`` of the check's program on ``device`` (default
    ``"cuda"``)."""
    device = require_device("cuda" if device is None else device, "test_install")
    rng = np.random.RandomState(seed)
    w_gt = rng.randn(dim)
    x = rng.randn(1000, dim)
    y = ((x @ w_gt + 0.1 * rng.randn(1000)) > 0).astype(np.float32)
    train = (x[:500].astype(np.float32), y[:500])
    valid = (x[500:].astype(np.float32), y[500:])

    outer = Outer(
        name="outer",
        module=from_fn(lambda p: p["w"], {"w": torch.ones(dim, device=device)}),
        optimizer=optim.sgd(lr=1.0, momentum=0.9),
        train_data_loader=[valid],
        config=Config(),
    )
    inner = Inner(
        name="inner",
        module=from_fn(lambda p, i: (i @ p["w"], p["w"]), {"w": torch.zeros(dim, device=device)}),
        optimizer=optim.sgd(lr=0.1),
        train_data_loader=[train],
        config=Config(type="cg", cg_iterations=3, cg_alpha=1.0, unroll_steps=100),
    )
    engine = Engine(
        config=EngineConfig(train_iters=train_iters),
        problems=[outer, inner],
        dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
        device=device,
    )
    return engine, outer


def main(train_iters=2000, dim=20, seed=0, device=None):
    """Run the check; returns the final outer loss (raises if it is not
    below 0.48)."""
    engine, outer = build_engine(train_iters, dim, seed, device)
    engine.run()
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    loss = float(outer.eval_loss(ctx, outer.cur_batch)[0])
    if not loss < 0.48:
        raise RuntimeError(f"install check failed (loss={loss})")
    print(f"Hello (Betty-TPU) World — install OK, final outer loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    main(device=ap.parse_args().device)
