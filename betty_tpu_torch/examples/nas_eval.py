"""DARTS evaluation phase: train a searched genotype from scratch.

Port of ``examples/neural_architecture_search/train.py`` (reference
``train.py``): the ``DARTSEvalNetwork`` of a genotype (36 channels, 20
cells), an auxiliary head with loss weight 0.4, drop-path ramped linearly
with the epoch to 0.2, cutout 16, SGD 0.025 with momentum 0.9, weight decay
3e-4 and a cosine LR, gradients clipped to a global norm of 5: a
single-problem program. The drop-path probability rides in every batch as
a scalar (``EvalLoader``), so it is a per-step value, not a constant of a
compiled period.

The genotype comes from ``--genotype-file`` (JSON from either package's
search, ``genotype_to_json``) or is the published DARTS_V2. Synthetic
CIFAR-shaped data by default, the test accuracy of each validation on 1024
synthetic images; ``--data-dir`` reads a local CIFAR-10 copy (the pickle
directory or an npz, ``vision_data.load_classification``): the classes
counted from its labels, its test set for the test accuracy, and each
training batch cropped and flipped on the host (``BatchLoader``'s
augmentation, before cutout), as the JAX ``train.py`` does exactly when it
is given a directory.

    python -m betty_tpu_torch.examples.nas_eval --auxiliary --cutout
    python -m betty_tpu_torch.examples.nas_eval --device cpu --init_channels 4 \\
        --layers 4 --batch_size 8 --train_size 32 --epochs 2 --auxiliary
    python -m betty_tpu_torch.examples.nas_eval --data-dir ~/cifar10 --auxiliary --cutout

``--compile_blocks`` runs the steps as compiled blocks (on CUDA one graph
replay a step); ``--checkpoint_dir`` saves an engine checkpoint whenever
the test accuracy improves; ``--logger tensorboard|wandb`` logs through
``betty_tpu_torch.logging``'s sinks (stdout when their package is missing).
"""

import argparse
from pathlib import Path

import numpy as np
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.examples.learning_to_reweight import BatchLoader, make_synthetic_cifar
from betty_tpu_torch.examples.vision_data import load_classification, problem_accuracy
from betty_tpu_torch.models.darts import DARTS_V2, DARTSEvalNetwork, genotype_from_json
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.utils import require_device


def cutout_batch(x, length, rng):
    """Cutout (reference ``utils.Cutout``): zero a random length x length
    square of each image (clipped at the borders)."""
    n, h, w, _ = x.shape
    ys = rng.randint(0, h, n)
    xs = rng.randint(0, w, n)
    x = x.copy()
    for i in range(n):
        y0, y1 = max(0, ys[i] - length // 2), min(h, ys[i] + length // 2)
        x0, x1 = max(0, xs[i] - length // 2), min(w, xs[i] + length // 2)
        x[i, y0:y1, x0:x1, :] = 0.0
    return x


class EvalLoader(BatchLoader):
    """Training batches with cutout and the scheduled drop-path probability
    appended: ``drop_path_prob * min(epoch / epochs, 1)``."""

    def __init__(self, x, y, batch_size, *, drop_path_prob, epochs, cutout_length=0, **kw):
        super().__init__(x, y, batch_size, **kw)
        # postprocess always appends the drop-path scalar
        self.postprocess_is_identity = False
        self.drop_path_prob = drop_path_prob
        self.epochs = max(epochs, 1)
        self.cutout_length = cutout_length
        self._cut_rng = np.random.RandomState(kw.get("seed", 0) + 123)

    def postprocess(self, batch):
        x, y = super().postprocess(batch)
        if self.cutout_length > 0:
            x = cutout_batch(np.asarray(x), self.cutout_length, self._cut_rng)
        dp = self.drop_path_prob * min(self.epoch / self.epochs, 1.0)
        return x, y, np.float32(dp)


class Network(ImplicitProblem):
    aux_weight = 0.4

    def training_step(self, batch):
        x, y, dp = batch
        logits, aux = self.module(x, dp)
        loss = F.cross_entropy(logits, y)
        if aux is not None:
            loss = loss + self.aux_weight * F.cross_entropy(aux, y)
        acc = (logits.argmax(dim=1) == y).float().mean() * 100
        return {"loss": loss, "acc": acc}


class _Logits:
    """A problem's forward without the auxiliary output, for
    ``problem_accuracy``."""

    def __init__(self, problem):
        self.problem = problem
        self.device = problem.device

    def __call__(self, x):
        return self.problem(x)[0]


class EvalEngine(Engine):
    """Validation: test accuracy; a checkpoint into ``ckpt_dir`` on each
    improvement."""

    test_data = None
    ckpt_dir = None
    best_acc = -1.0

    def validation(self):
        if self.test_data is None:
            return {}
        x, y = self.test_data
        acc = problem_accuracy(_Logits(self.network), x, y)
        if acc > self.best_acc:
            self.best_acc = acc
            if self.ckpt_dir:
                self.save_checkpoint(self.ckpt_dir)
        return {"test_acc": acc, "best_acc": self.best_acc}


def build_engine(args):
    device = require_device(args.device, "nas_eval")
    genotype = (genotype_from_json(Path(args.genotype_file).read_text())
                if args.genotype_file else DARTS_V2)
    if args.data_dir:
        x_tr, y_tr, x_te, y_te = load_classification(args.data_dir)
        num_classes = int(y_tr.max()) + 1
    else:
        x_tr, y_tr = make_synthetic_cifar(args.train_size, seed=0)
        x_te, y_te = make_synthetic_cifar(1024, seed=9)
        num_classes = 10
    steps_per_epoch = max(len(x_tr) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epochs

    net = DARTSEvalNetwork(genotype, channels=args.init_channels, layers=args.layers,
                           num_classes=num_classes, auxiliary=args.auxiliary, device=device,
                           seed=args.seed)
    loader = EvalLoader(x_tr, y_tr, args.batch_size, drop_path_prob=args.drop_path_prob,
                        epochs=args.epochs, cutout_length=args.cutout_length if args.cutout else 0,
                        augment=args.data_dir is not None, seed=args.seed)
    network = Network(
        "network",
        module=from_torch(net, rng_names=("dropout", "droppath")),
        optimizer=optim.sgd(lr=args.learning_rate, momentum=args.momentum,
                            weight_decay=args.weight_decay,
                            schedule=optim.cosine_lr(args.learning_rate, total_steps)),
        train_data_loader=loader,
        config=Config(gradient_clipping=args.grad_clip),
    )
    engine = EvalEngine(
        config=EngineConfig(train_iters=total_steps,
                            valid_step=steps_per_epoch * args.valid_every_epochs,
                            logger_type=args.logger, compile_blocks=args.compile_blocks),
        problems=[network], dependencies={"u2l": {}, "l2u": {}}, device=device)
    engine.test_data = (x_te, y_te)
    engine.ckpt_dir = args.checkpoint_dir
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--genotype-file", dest="genotype_file", type=str, default=None,
                   help="JSON genotype from the search phase (default: DARTS_V2)")
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="CIFAR-10 pickle directory or npz (augmented on the host); "
                        "synthetic if unset")
    p.add_argument("--train_size", type=int, default=512,
                   help="synthetic dataset size when no --data-dir")
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--init_channels", type=int, default=36)
    p.add_argument("--layers", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=0.025)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=3e-4)
    p.add_argument("--grad_clip", type=float, default=5.0)
    p.add_argument("--auxiliary", action="store_true")
    p.add_argument("--drop_path_prob", type=float, default=0.2)
    p.add_argument("--cutout", action="store_true")
    p.add_argument("--cutout_length", type=int, default=16)
    p.add_argument("--valid_every_epochs", type=int, default=1)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--logger", type=str, default="none")
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a step")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
