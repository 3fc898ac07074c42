"""Tutorial 4: memory and precision (``tutorial/4_memory_optimization.py``).

``Config(precision="bf16")`` runs a problem's forwards and backwards in
bfloat16 on float32 master parameters, with no loss scaling (``"fp16"`` is
taken as bf16); the hypergradient passes stay float32
(``solver_precision``). ``gradient_accumulation=2`` steps the classifier
once every two batches of 64 (an effective batch of 128); darts, a
first-order solver, keeps the hypergradient lean.

    python -m betty_tpu_torch.tutorial.4_memory_optimization      # on cuda
    python -m betty_tpu_torch.tutorial.4_memory_optimization --device cpu
"""

import argparse

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device


def build_engine(args):
    device = require_device(args.device, "tutorial 4")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(64, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, 64),
        config=Config(type="darts", unroll_steps=1, precision="bf16",
                      gradient_accumulation=2, log_step=500),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(64, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, 64, seed=1),
        config=Config(type="darts", precision="bf16", log_step=500),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_iters", type=int, default=2000)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
