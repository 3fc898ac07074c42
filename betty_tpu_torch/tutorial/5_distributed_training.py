"""Tutorial 5: distributed training (``tutorial/5_distributed_training.py``).

One config line runs the reweighting program of tutorial 1 data-parallel,
one process a rank:

* ``strategy="dp"``   data parallel: each rank loads its own examples,
                      parameters replicated, gradients averaged over the
                      ranks (the reference Betty's ``"distributed"``)
* ``strategy="zero"`` and each rank keeps its shard of the optimizer state
                      (ZeRO-1)
* ``strategy="fsdp"`` and each rank keeps its shard of the parameters and
                      gradients too

The ranks come from ``torchrun`` or from the JAX package's variables
(``BETTY_COORDINATOR_ADDRESS``, ``BETTY_NUM_PROCESSES``,
``BETTY_PROCESS_ID``); without either the run is a world of one. On the
CPU the ranks talk over gloo, on the card over NCCL (``--backend`` picks
another, e.g. gloo with CUDA tensors for several ranks on one card):

    torchrun --nproc_per_node 2 -m betty_tpu_torch.tutorial.5_distributed_training \\
        --device cpu --strategy fsdp --train_iters 200

Each rank loads ``--batch_size`` examples a step, so the global batch is
the ranks times that.
"""

import argparse

from betty_tpu_torch import Config, Engine, EngineConfig, optim, parallel
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device


def build_engine(args):
    device = require_device(args.device, "tutorial 5")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    classifier = Classifier(
        name="classifier",
        module=classifier_module(args.batch_size, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, args.batch_size, shuffle=args.shuffle),
        config=Config(type="darts", unroll_steps=1, log_step=200),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(args.batch_size, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, args.batch_size, seed=1, shuffle=args.shuffle),
        config=Config(type="darts", log_step=200),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters, strategy=args.strategy),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--strategy", default="dp", choices=["default", "dp", "zero", "fsdp"])
    p.add_argument("--train_iters", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=128, help="examples a rank loads a step")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--no_shuffle", dest="shuffle", action="store_false",
                   help="unshuffled epochs: the global batch of N ranks is the batch of one "
                        "process loading N x --batch_size examples")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.strategy != "default":
        parallel.maybe_init_distributed(require_device(args.device, "tutorial 5"),
                                        backend=args.backend)
    engine = build_engine(args)
    engine.run()
    return engine


if __name__ == "__main__":
    main()
