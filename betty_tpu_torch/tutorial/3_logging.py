"""Tutorial 3: logging (``tutorial/3_logging.py``).

``EngineConfig.logger_type`` chooses the sink (``"none"``, ``"tensorboard"``
or ``"wandb"``; without its package a sink falls back to stdout), each
problem's ``log_step`` the cadence (here TensorBoard, every 100 steps);
``training_step`` may return a dict of metrics beside ``"loss"``
(``Reweight`` adds ``"acc"``). TensorBoard writes under
``betty_tensorboard/`` in the working directory.

    python -m betty_tpu_torch.tutorial.3_logging                  # on cuda
    python -m betty_tpu_torch.tutorial.3_logging --device cpu
"""

import argparse

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device


def build_engine(args):
    device = require_device(args.device, "tutorial 3")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(128, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, 128),
        config=Config(type="darts", unroll_steps=1, log_step=100),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(128, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, 128, seed=1),
        config=Config(type="darts", log_step=100),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters, logger_type="tensorboard"),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_iters", type=int, default=1000)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
