"""Tutorial 1: quick start (``tutorial/1_quick_start.py``).

A bilevel data-reweighting program in a few lines of user code: two
problems, a dependency dict, an engine. ``--baseline`` trains the
classifier alone, for comparison.

    python -m betty_tpu_torch.tutorial.1_quick_start              # on cuda
    python -m betty_tpu_torch.tutorial.1_quick_start --device cpu --baseline
"""

import argparse

import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device


class Plain(Classifier):
    """Single level: the plain cross-entropy, no reweighting."""

    def training_step(self, batch):
        inputs, labels = batch
        return F.cross_entropy(self.module(inputs), labels.long())


def build_engine(args):
    device = require_device(args.device, "tutorial 1")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    if args.baseline:
        classifier = Plain(
            name="classifier",
            module=classifier_module(args.batch_size, device=device),
            optimizer=optim.sgd(lr=0.1, momentum=0.9),
            train_data_loader=Loader(x_train, y_train, args.batch_size),
            config=Config(log_step=500),
        )
        return Engine(config=EngineConfig(train_iters=args.train_iters), problems=[classifier],
                      dependencies={"u2l": {}, "l2u": {}}, device=device)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(args.batch_size, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, args.batch_size),
        config=Config(type="darts", unroll_steps=1, log_step=500),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(args.batch_size, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, args.batch_size, seed=1),
        config=Config(type="darts", log_step=500),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--baseline", action="store_true")
    p.add_argument("--train_iters", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
