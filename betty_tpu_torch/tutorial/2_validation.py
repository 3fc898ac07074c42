"""Tutorial 2: validation (``tutorial/2_validation.py``).

Subclass ``Engine`` and implement ``validation()``: it runs every
``valid_step`` iterations with every problem in eval mode. Here it reads
the classifier's logits back to the host batch by batch, as the JAX
tutorial does, and returns the test accuracy.

    python -m betty_tpu_torch.tutorial.2_validation               # on cuda
    python -m betty_tpu_torch.tutorial.2_validation --device cpu
"""

import argparse

import torch

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device


class ReweightingEngine(Engine):
    test_data = None

    def validation(self):
        x_test, y_test = self.test_data
        correct, total = 0, 0
        for i in range(0, len(x_test), 128):
            xb = torch.from_numpy(x_test[i:i + 128]).to(self.device)
            yb = y_test[i:i + 128]
            logits = self.classifier.module(xb).detach().cpu().numpy()
            correct += (logits.argmax(axis=1) == yb).sum()
            total += len(yb)
        return {"acc": 100.0 * correct / total}


def build_engine(args):
    device = require_device(args.device, "tutorial 2")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(128, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, 128),
        config=Config(type="darts", unroll_steps=1),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(128, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, 128, seed=1),
        config=Config(type="darts"),
    )
    engine = ReweightingEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )
    engine.test_data = make_imbalanced_mnist(n=512, imbalance=1, seed=2)
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_iters", type=int, default=3000)
    p.add_argument("--valid_step", type=int, default=500)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
