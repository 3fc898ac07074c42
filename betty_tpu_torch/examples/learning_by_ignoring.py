"""Learning by ignoring: a 3-problem domain-adaptation program with
per-group learning rates.

Port of ``examples/learning_by_ignoring/main.py``. ``pretrain`` trains an
``MLP`` on the source domain with a learned ignore weight
``sigmoid(score)`` per source example, ``finetune`` trains a second
``MLP`` on the target domain with a proximal term to ``pretrain``'s
weights, and ``reweight`` (the per-example scores) takes the finetuned
model's validation loss. The graph is ``u2l={reweight: [pretrain]}``,
``l2u={pretrain: [finetune, reweight], finetune: [reweight]}``, so two
hypergradient paths reach ``reweight``: ``[reweight, pretrain, reweight]``
and ``[reweight, pretrain, finetune, reweight]``, darts on every edge,
unroll 1.

``Finetune.param_groups`` gives the feature layer (``layers.0.``, the
port's name for flax's ``Dense_0``) ``--features_lr`` and every other leaf
``--classifier_lr``; at the defaults (both 0.05) the two groups step
alike. Labels are int64.

The defaults are the JAX example's (dim 32, 5 classes, 512 source and 256
target examples, batch 64, ``MLP([64, 5])``, SGD 0.05 with momentum 0.9,
Adam 0.01 on the scores, rho 0.1), synthetic Gaussian-cluster domains.
``--data-dir`` reads an OfficeHome-style feature npz (``x_src, y_src,
x_tgt, y_tgt, x_val, y_val`` and optionally ``x_test, y_test``).

    python -m betty_tpu_torch.examples.learning_by_ignoring
    python -m betty_tpu_torch.examples.learning_by_ignoring --device cpu --train_iters 8

``--compile_blocks`` runs the steady schedule as compiled blocks.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.examples.vision_data import problem_accuracy
from betty_tpu_torch.models.mlp import MLP
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.utils import require_device, tree_leaves


def make_domain(n, dim, num_classes, seed, shift=0.0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(num_classes, dim) * 2 + shift
    y = rng.randint(0, num_classes, n)
    x = centers[y] + rng.randn(n, dim)
    return x.astype(np.float32), y.astype(np.int64)


class Pretrain(ImplicitProblem):
    """Source-domain training with learned per-example ignore weights."""

    def training_step(self, batch):
        x, y, idx = batch
        losses = F.cross_entropy(self.module(x), y, reduction="none")
        weights = torch.sigmoid(self.reweight()[idx])
        return torch.mean(weights * losses)


class Finetune(ImplicitProblem):
    """Target-domain fine-tuning with a proximal term to the pretrained
    weights."""

    def training_step(self, batch):
        x, y = batch
        loss = F.cross_entropy(self.module(x), y)
        prox = sum(torch.sum((a - b) ** 2)
                   for a, b in zip(tree_leaves(self.params), tree_leaves(self.pretrain.params)))
        return loss + self.cfg["rho"] * prox

    def param_groups(self):
        # the feature extractor and the classifier head
        return [
            {"select": r"^layers\.0\.", "lr": self.cfg["features_lr"]},
            {"select": None, "lr": self.cfg["classifier_lr"]},
        ]


class Reweight(ImplicitProblem):
    """Top level: the finetuned model's validation loss drives the
    per-source-example ignore scores."""

    def training_step(self, batch):
        x, y = batch
        logits = self.finetune(x)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(dim=1) == y).float().mean() * 100
        return {"loss": loss, "acc": acc}


class LBIEngine(Engine):
    """Target-test accuracy of the finetuned model at each validation."""

    test_data = None

    def validation(self):
        if self.test_data is None:
            return {}
        x, y = self.test_data
        return {"test_acc": problem_accuracy(self.finetune, x, y)}


def load_features(path):
    """An OfficeHome-style feature npz: ``(source, target, validation,
    test or None)``, each ``(x float32, y int64)``."""
    d = np.load(path)

    def pair(split):
        return np.asarray(d[f"x_{split}"], np.float32), np.asarray(d[f"y_{split}"], np.int64)

    test = pair("test") if "x_test" in d else None
    return pair("src"), pair("tgt"), pair("val"), test


def build_engine(args):
    device = require_device(args.device, "learning_by_ignoring")
    test_data = None
    if getattr(args, "data_dir", None):
        (xs, ys), (xt, yt), (xv, yv), test_data = load_features(args.data_dir)
        args.n_source, args.n_target = len(ys), len(yt)
        args.dim = xs.shape[1]
        args.classes = int(max(ys.max(), yt.max())) + 1
    else:
        xs, ys = make_domain(args.n_source, args.dim, args.classes, 0, shift=0.0)
        xt, yt = make_domain(args.n_target, args.dim, args.classes, 1, shift=0.5)
        xv, yv = make_domain(args.n_target, args.dim, args.classes, 2, shift=0.5)

    b = args.batch
    idx = np.arange(args.n_source, dtype=np.int64)
    src_loader = [(xs[i:i + b], ys[i:i + b], idx[i:i + b])
                  for i in range(0, args.n_source - b + 1, b)]
    tgt_loader = [(xt[i:i + b], yt[i:i + b]) for i in range(0, args.n_target - b + 1, b)]
    val_loader = [(xv[i:i + b], yv[i:i + b]) for i in range(0, args.n_target - b + 1, b)]

    def make_net(seed):
        return from_torch(MLP(args.dim, [64, args.classes], device=device,
                              generator=torch.Generator(device=device).manual_seed(seed)))

    pretrain = Pretrain(
        name="pretrain", module=make_net(0),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9),
        train_data_loader=src_loader,
        config=Config(type="darts", unroll_steps=1, allow_unused=False),
    )
    finetune = Finetune(
        name="finetune", module=make_net(1),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9),
        train_data_loader=tgt_loader,
        config=Config(type="darts", unroll_steps=1, allow_unused=False),
        extra_config={"rho": args.rho, "features_lr": args.features_lr,
                      "classifier_lr": args.classifier_lr},
    )
    reweight = Reweight(
        name="reweight",
        module=from_fn(lambda p: p["scores"], {"scores": torch.zeros(args.n_source)}),
        optimizer=optim.adam(lr=args.meta_lr),
        train_data_loader=val_loader,
        config=Config(type="darts", unroll_steps=1, log_step=args.log_step),
    )
    engine = LBIEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                            compile_blocks=args.compile_blocks),
        problems=[reweight, finetune, pretrain],
        dependencies={"u2l": {reweight: [pretrain]},
                      "l2u": {pretrain: [finetune, reweight], finetune: [reweight]}},
        device=device,
    )
    engine.test_data = test_data
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--classes", type=int, default=5)
    p.add_argument("--n_source", type=int, default=512)
    p.add_argument("--n_target", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--features_lr", type=float, default=0.05)
    p.add_argument("--classifier_lr", type=float, default=0.05)
    p.add_argument("--meta_lr", type=float, default=0.01)
    p.add_argument("--rho", type=float, default=0.1)
    p.add_argument("--train_iters", type=int, default=200)
    p.add_argument("--valid_step", type=int, default=1000)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="OfficeHome-style feature npz; synthetic if unset")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    print("ignore-score stats:",
          float(torch.sigmoid(engine.states["reweight"]["params"]["scores"]).mean()))
    return engine


if __name__ == "__main__":
    main()
