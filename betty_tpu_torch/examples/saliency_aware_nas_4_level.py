"""Saliency-aware NAS: a 4-level program (three problems and a PGD attack
stage inside a training step).

Port of ``examples/saliency_aware_nas_4_level/main.py``. The graph is
``u2l={outer: [inner2, inner1]}``, ``l2u={inner1: [inner2, outer], inner2:
[outer]}``, so the outer problem (a feature-saliency mask on clean data,
``first_order=True``) takes three hypergradient paths, ``[outer, inner2,
outer]``, ``[outer, inner2, inner1, outer]`` (two darts hops) and
``[outer, inner1, outer]``. ``Inner2`` learns a per-feature perturbation
budget ``eps = softplus(param)``; its loss runs ``pgd_steps`` steps of a
sign-gradient attack against the classifier ``Inner1`` inside the step.

The attack takes ``torch.autograd.grad`` with respect to ``delta`` alone
and without ``create_graph``, so no graph of the loop reaches the engine's
backward (JAX's ``stop_gradient`` of the loop). The final projection is
``minimum(maximum(delta, -eps), eps)``, JAX's ``jnp.clip``: at a tie
(every clipped element equals ``eps`` exactly) it sends half the gradient
to ``eps``, as ``lax.max``/``lax.min`` do, where ``torch.clamp`` with
tensor bounds sends none; that projection is the budget's only
data-dependent gradient. ``softplus`` is ``logaddexp(x, 0)`` (``F.softplus``
turns linear above 20). Labels are int64.

The defaults are the JAX example's (dim 32, 5 classes, n 512, batch 64,
``MLP([64, 5])``, 3 PGD steps at 0.05, unroll 2 and 2, Adam 1e-3 on both
upper problems, SGD 0.05 with momentum 0.9 on the classifier), synthetic
Gaussian-cluster data. ``--data-dir`` reads a classification npz
(``x_train``, ``y_train``; rows flattened to features) and splits it into
thirds for the classifier, the budget and the mask, in that order; ``dim``
and ``classes`` then come from the data.

    python -m betty_tpu_torch.examples.saliency_aware_nas_4_level
    python -m betty_tpu_torch.examples.saliency_aware_nas_4_level --device cpu --train_iters 8

``--compile_blocks`` runs the steady schedule as compiled blocks.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.models.mlp import MLP, softplus
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.utils import require_device


def make_data(n, dim, classes, seed):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim) * 2
    y = rng.randint(0, classes, n)
    x = (centers[y] + rng.randn(n, dim)).astype(np.float32)
    return x, y.astype(np.int64)


def project(delta, eps):
    """``jnp.clip(delta, -eps, eps)`` with JAX's gradients at ties."""
    return torch.minimum(torch.maximum(delta, -eps), eps)


def pgd_attack(attack_loss, x, eps, steps, lr):
    """``steps`` sign-gradient ascent steps on ``attack_loss(delta)`` from
    0, each projected onto ``[-eps, eps]``; the iterates carry no gradient
    (JAX's ``stop_gradient`` of the loop)."""
    bound = eps.detach()
    delta = torch.zeros_like(x)
    for _ in range(steps):
        d = delta.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(attack_loss(d), d)
        delta = project(delta + lr * torch.sign(g), bound)
    return delta


class Outer(ImplicitProblem):
    """Level 4: the architecture weights (a feature-saliency mask) on clean
    validation data."""

    def training_step(self, batch):
        x, y = batch
        logits = self.inner1(x * torch.sigmoid(self.module()))
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(dim=1) == y).float().mean() * 100
        return {"loss": loss, "acc": acc}


class Inner2(ImplicitProblem):
    """Levels 3 and 2: the perturbation-budget learner, whose loss runs a
    PGD attack (the fourth level) against the classifier."""

    def training_step(self, batch):
        x, y = batch
        mask = torch.sigmoid(self.outer())
        eps = softplus(self.module())

        def attack_loss(delta):
            return F.cross_entropy(self.inner1((x + delta) * mask), y)

        delta = pgd_attack(attack_loss, x, eps, self.cfg["pgd_steps"], self.cfg["pgd_lr"])
        # the final projection stays differentiable in eps: the only
        # data-dependent path from the robust gap to the budget
        delta = project(delta, eps)

        adv_logits = self.inner1((x + delta) * mask)
        clean_logits = self.inner1(x * mask)
        robust_gap = F.cross_entropy(adv_logits, y) - F.cross_entropy(clean_logits, y)
        return robust_gap + 0.1 * torch.mean(eps)


class Inner1(ImplicitProblem):
    """Level 1: the classifier on masked data."""

    def training_step(self, batch):
        x, y = batch
        mask = torch.sigmoid(self.outer())
        return F.cross_entropy(self.module(x * mask), y)


class SanasEngine(Engine):
    """Validation: the classifier's accuracy on masked held-out data."""

    test_data = None

    def validation(self):
        if self.test_data is None:
            return {}
        x, y = (torch.as_tensor(a, device=self.device) for a in self.test_data)
        with torch.no_grad():
            logits = self.inner1(x * torch.sigmoid(self.outer()))
        return {"masked_acc": 100.0 * float((logits.argmax(dim=1) == y).float().mean())}


def build_engine(args):
    device = require_device(args.device, "saliency_aware_nas_4_level")
    if args.data_dir:
        d = np.load(args.data_dir)
        x = np.asarray(d["x_train"], np.float32)
        x = x.reshape(len(x), -1)
        y = np.asarray(d["y_train"], np.int64)
        third = len(y) // 3
        x_tr, y_tr = x[:third], y[:third]
        x_v1, y_v1 = x[third:2 * third], y[third:2 * third]
        x_v2, y_v2 = x[2 * third:], y[2 * third:]
        args.dim, args.classes = x.shape[1], int(y.max()) + 1
    else:
        x_tr, y_tr = make_data(args.n, args.dim, args.classes, 0)
        x_v1, y_v1 = make_data(args.n, args.dim, args.classes, 1)
        x_v2, y_v2 = make_data(args.n, args.dim, args.classes, 2)

    # held-out data for validation(): the last 20% of the outer split never
    # enters a training loader
    holdout = max(len(y_v2) // 5, 1)
    x_test, y_test = x_v2[-holdout:], y_v2[-holdout:]
    x_v2, y_v2 = x_v2[:-holdout], y_v2[:-holdout]

    def loader(x, y):
        return [(x[i:i + args.batch], y[i:i + args.batch])
                for i in range(0, len(x) - args.batch + 1, args.batch)]

    outer = Outer(
        name="outer",
        module=from_fn(lambda p: p["mask"], {"mask": torch.zeros(args.dim)}),
        optimizer=optim.adam(lr=args.arch_lr),
        train_data_loader=loader(x_v2, y_v2),
        config=Config(type="darts", first_order=True, log_step=args.log_step),
    )
    inner2 = Inner2(
        name="inner2",
        module=from_fn(lambda p: p["eps"], {"eps": -2.0 * torch.ones(args.dim)}),
        optimizer=optim.adam(lr=args.budget_lr),
        train_data_loader=loader(x_v1, y_v1),
        config=Config(type="darts", unroll_steps=args.unroll2),
        extra_config={"pgd_steps": args.pgd_steps, "pgd_lr": args.pgd_lr},
    )
    inner1 = Inner1(
        name="inner1",
        module=from_torch(MLP(args.dim, [64, args.classes], device=device,
                              generator=torch.Generator(device=device).manual_seed(0))),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9),
        train_data_loader=loader(x_tr, y_tr),
        config=Config(type="darts", unroll_steps=args.unroll1),
    )
    engine = SanasEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                            compile_blocks=args.compile_blocks),
        problems=[outer, inner2, inner1],
        dependencies={"u2l": {outer: [inner2, inner1]},
                      "l2u": {inner1: [inner2, outer], inner2: [outer]}},
        device=device,
    )
    engine.test_data = (x_test, y_test)
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--arch_lr", type=float, default=1e-3)
    p.add_argument("--budget_lr", type=float, default=1e-3)
    p.add_argument("--pgd_steps", type=int, default=3)
    p.add_argument("--pgd_lr", type=float, default=0.05)
    p.add_argument("--unroll1", type=int, default=2)
    p.add_argument("--unroll2", type=int, default=2)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--valid_step", type=int, default=50)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="classification npz (x_train/y_train); synthetic if unset")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    mask = torch.sigmoid(engine.states["outer"]["params"]["mask"])
    print("saliency mask mean:", float(mask.mean()))
    return engine


if __name__ == "__main__":
    main()
