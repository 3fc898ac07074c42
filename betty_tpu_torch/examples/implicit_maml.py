"""Implicit MAML (iMAML): few-shot classification fed by a task
environment.

Port of ``examples/implicit_maml/main.py``. ``meta`` (the meta
initialization, Adam) sits over ``inner`` (task adaptation, SGD, with a
proximal term ``0.5 * reg * |params - meta|^2``), ``u2l={meta: [inner]}``,
``l2u={inner: [meta]}``. Both take their batches from a ``MAMLEnv``
(``envs.Env``): ``inner`` the task's support set, ``meta`` its query set.
``MAMLEngine.train_step`` steps the env, drawing a new task, at each
inner-loop start; ``Inner.on_inner_loop_start`` warm-starts the inner
problem from the meta weights (a copy). The meta problem takes a CG
hypergradient (3 iterations, ``cg_alpha`` 1.0) and accumulates
``meta_batch_size`` tasks' gradients before each Adam step. The backbone
is ``models/omniglot.py::OmniglotCNN`` on 28x28 NHWC images.

The env's ``numpy.random.RandomState`` stream is consumed in JAX's order,
so the tasks are the JAX example's arrays. Synthetic tasks (class
prototypes plus noise) by default; ``--data-dir`` reads an Omniglot npz
(``images (N, 28, 28[, 1])``, ``labels``) split into class-disjoint
meta-train and meta-test pools, and ``validation`` then fine-tunes fresh
copies of the meta weights on ``--eval_tasks`` held-out tasks
(``inner_steps`` SGD steps in eval mode) and reports the query accuracy.
Labels are int64.

The engine overrides ``train_step``, so ``compile_blocks`` would run it in
driver mode (``Engine.run_compiled``); the example has no such flag.

    python -m betty_tpu_torch.examples.implicit_maml
    python -m betty_tpu_torch.examples.implicit_maml --device cpu --ways 3 --inner_steps 2 \\
        --meta_batch_size 2 --train_iters 8
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.envs import Env
from betty_tpu_torch.examples.vision_data import load_omniglot
from betty_tpu_torch.models.omniglot import OmniglotCNN
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.utils import require_device, tree_leaves, tree_map, value_and_grad


class MAMLEnv(Env):
    """One few-shot task per inner loop: synthetic class prototypes plus
    noise, or ``ways`` classes sampled from an ``(images, labels,
    class_ids)`` pool. ``support`` and ``query`` are ``(x float32 NHWC, y
    int64)``."""

    def __init__(self, ways=5, shots=1, query_shots=5, image=28, seed=0, pool=None):
        super().__init__()
        self.ways, self.shots, self.query_shots = ways, shots, query_shots
        self.image = image
        self.rng = np.random.RandomState(seed)
        self.pool = pool
        self.support = None
        self.query = None
        self.step()

    def step(self):
        if self.pool is not None:
            self.support, self.query = sample_task_from_pool(
                self.pool, self.ways, self.shots, self.query_shots, self.rng)
            return
        protos = self.rng.randn(self.ways, self.image, self.image, 1) * 1.0

        def sample(n_per_class):
            xs, ys = [], []
            for c in range(self.ways):
                noise = self.rng.randn(n_per_class, self.image, self.image, 1)
                xs.append(protos[c][None] + 0.5 * noise)
                ys.append(np.full(n_per_class, c))
            x = np.concatenate(xs).astype(np.float32)
            y = np.concatenate(ys).astype(np.int64)
            order = self.rng.permutation(len(x))
            return x[order], y[order]

        self.support = sample(self.shots)
        self.query = sample(self.query_shots)


def sample_task_from_pool(pool, ways, shots, query_shots, rng):
    """One N-way K-shot task from a class-indexed example pool."""
    images, labels, class_ids = pool
    chosen = rng.choice(class_ids, size=ways, replace=False)
    sx, sy, qx, qy = [], [], [], []
    for new_label, c in enumerate(chosen):
        idx = np.flatnonzero(labels == c)
        idx = rng.permutation(idx)[:shots + query_shots]
        sx.append(images[idx[:shots]])
        sy.append(np.full(shots, new_label))
        qx.append(images[idx[shots:]])
        qy.append(np.full(len(idx) - shots, new_label))

    def cat(xs, ys):
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.int64)
        order = rng.permutation(len(x))
        return x[order], y[order]

    return cat(sx, sy), cat(qx, qy)


def prox(params, anchor):
    """``sum |a - b|^2`` over the two trees' leaves in one fixed order."""
    return sum(torch.sum((a - b) ** 2) for a, b in zip(tree_leaves(params), tree_leaves(anchor)))


class Meta(ImplicitProblem):
    def training_step(self, batch):
        x, y = batch
        logits = self.inner(x)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(dim=1) == y).float().mean() * 100
        return {"loss": loss, "acc": acc}

    def get_batch(self):
        return self._convert_batch(self.env.query)


class Inner(ImplicitProblem):
    def training_step(self, batch):
        x, y = batch
        loss = F.cross_entropy(self.module(x), y)
        # proximal regularization to the meta weights
        return loss + 0.5 * self.cfg["reg"] * prox(self.params, self.meta.params)

    def get_batch(self):
        return self._convert_batch(self.env.support)

    def on_inner_loop_start(self):
        # warm start from the meta initialization
        self.set_params(self.meta.params)


class MAMLEngine(Engine):
    """Draws a new task at each inner-loop start; ``validation`` fine-tunes
    fresh copies of the meta weights on held-out tasks."""

    test_pool = None  # (images, labels, class_ids) of the meta-test classes
    eval_tasks = 20
    maml_args = None

    def train_step(self):
        if self.inner._inner_loop_start:
            self.env.step()
        super().train_step()

    def validation(self):
        if self.test_pool is None:
            return {}
        a = self.maml_args
        rng = np.random.RandomState(1234)
        extra = self.states["inner"]["extra"]  # the inner problem's batch_stats
        apply = self.inner.module_fn.apply
        accs = []
        for _ in range(self.eval_tasks):
            (sx, sy), (qx, qy) = sample_task_from_pool(self.test_pool, a.ways, a.shots, 5, rng)
            params = self.meta.params  # a fresh fine-tune from the meta weights
            like = next(iter(params.values()))
            sx_d = torch.as_tensor(sx, device=self.device, dtype=like.dtype)
            sy_d = torch.as_tensor(sy, device=self.device)

            def loss_fn(p):
                return F.cross_entropy(apply({"params": p, **extra}, sx_d, train=False), sy_d)

            for _ in range(a.inner_steps):
                _, g = value_and_grad(loss_fn, params, argnums=0)
                params = tree_map(lambda p, gi: p - a.inner_lr * gi, params, g)
            with torch.no_grad():
                logits = apply({"params": params, **extra},
                               torch.as_tensor(qx, device=self.device, dtype=like.dtype),
                               train=False)
            accs.append(float((logits.argmax(dim=1).cpu().numpy() == qy).mean()))
        return {"meta_test_acc": 100.0 * float(np.mean(accs))}


def split_omniglot_pools(data_dir, holdout_frac=0.2, seed=0):
    """Class-disjoint meta-train and meta-test pools from an Omniglot npz."""
    images, labels = load_omniglot(data_dir)
    classes = np.unique(labels)
    rng = np.random.RandomState(seed)
    rng.shuffle(classes)
    n_test = max(1, int(len(classes) * holdout_frac))
    test_cls, train_cls = classes[:n_test], classes[n_test:]
    return (images, labels, train_cls), (images, labels, test_cls)


def build_engine(args):
    device = require_device(args.device, "implicit_maml")
    train_pool = test_pool = None
    if getattr(args, "data_dir", None):
        train_pool, test_pool = split_omniglot_pools(args.data_dir)
    env = MAMLEnv(ways=args.ways, shots=args.shots, seed=args.seed, pool=train_pool)

    def net(seed):
        return from_torch(OmniglotCNN(num_classes=args.ways, device=device, seed=seed))

    meta = Meta(
        name="meta", module=net(0),
        optimizer=optim.adam(lr=args.meta_lr),
        config=Config(type="cg", cg_iterations=3, cg_alpha=1.0, unroll_steps=1,
                      gradient_accumulation=args.meta_batch_size, log_step=args.log_step),
    )
    inner = Inner(
        name="inner", module=net(1),
        optimizer=optim.sgd(lr=args.inner_lr),
        config=Config(unroll_steps=args.inner_steps),
        extra_config={"reg": args.reg},
    )
    engine = MAMLEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step),
        problems=[meta, inner],
        dependencies={"u2l": {meta: [inner]}, "l2u": {inner: [meta]}},
        env=env,
        device=device,
    )
    engine.test_pool = test_pool
    engine.eval_tasks = args.eval_tasks
    engine.maml_args = args
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ways", type=int, default=5)
    p.add_argument("--shots", type=int, default=1)
    p.add_argument("--inner_steps", type=int, default=5)
    p.add_argument("--meta_batch_size", type=int, default=4)
    p.add_argument("--inner_lr", type=float, default=0.1)
    p.add_argument("--meta_lr", type=float, default=1e-3)
    p.add_argument("--reg", type=float, default=2.0)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--valid_step", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="Omniglot npz (images, labels); synthetic if unset")
    p.add_argument("--eval_tasks", type=int, default=20)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
