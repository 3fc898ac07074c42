"""DARTS neural architecture search: the architecture's alphas over a
supernet classifier, darts hypergradient, ``roll_back=True``.

Port of ``examples/neural_architecture_search/main.py`` (reference
``train_search.py``). The arch problem holds the raw alphas; its loss runs
the classifier's supernet on the arch's batch with its own alphas
(``self.classifier.module(x, self.params)``), and the classifier's loss
takes the arch's (``self.module(x, self.arch.params)``). Only the
classifier's own step keeps the supernet's running statistics
(``Problem.forward``). The defaults are DARTS's search settings (16
channels, 8 cells, batch 64, SGD 0.025 with momentum 0.9, weight decay
3e-4 and a cosine LR; Adam 3e-4 with betas (0.5, 0.999) and weight decay
1e-3 on the alphas; unroll 1). Synthetic CIFAR-shaped data by default;
``--data-dir`` reads a local CIFAR-10 copy (the pickle directory or an
npz, ``vision_data.load_classification``), whose train set's first half
trains the weights and second half the architecture, and whose test set
gives ``test_acc`` at each validation (whole batches only, as the JAX
search counts). The derived genotype is logged at each validation and
written by ``--genotype-out`` as JSON, which ``examples/nas_eval.py`` (and
the JAX package's ``train.py``) read.

    python -m betty_tpu_torch.examples.neural_architecture_search
    python -m betty_tpu_torch.examples.neural_architecture_search --device cpu \\
        --channels 4 --layers 3 --batch_size 4 --train_size 32 --train_iters 4

``--compile_blocks`` runs the steady schedule as compiled blocks (on CUDA
one graph replay a meta-period); ``--checkpoint_dir`` with
``--checkpoint_step`` saves engine checkpoints there.

    python -m betty_tpu_torch.examples.neural_architecture_search --data-dir ~/cifar10 \
        --genotype-out genotype.json
"""

import argparse
from pathlib import Path

import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.examples.learning_to_reweight import BatchLoader, make_synthetic_cifar
from betty_tpu_torch.examples.vision_data import load_classification, problem_accuracy
from betty_tpu_torch.models.darts import (DARTSNetwork, derive_genotype, genotype_to_json,
                                          init_alphas)
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.utils import require_device


class Arch(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        return F.cross_entropy(self.classifier_fwd(inputs), labels)

    def classifier_fwd(self, inputs):
        # the supernet's forward with this problem's alphas
        return self.classifier.module(inputs, self.params)


class Classifier(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        logits = self.module(inputs, self.arch.params)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(dim=1) == labels).float().mean() * 100
        return {"loss": loss, "acc": acc}


def split_search_data(data_dir):
    """``(train, arch, test)`` pairs of a CIFAR copy: the first half of the
    train set trains the weights, the second half the architecture."""
    x_all, y_all, x_test, y_test = load_classification(data_dir)
    half = len(y_all) // 2
    return ((x_all[:half], y_all[:half]), (x_all[half:], y_all[half:]), (x_test, y_test))


class SearchEngine(Engine):
    """Validation: the derived genotype (logged), the test accuracy (with a
    test set) and the arch's loss on its current batch."""

    test_data = None  # (x, y) with --data-dir
    eval_batch = 256

    def validation(self):
        genotype = derive_genotype(self.arch.params)
        self.logger.info(f"genotype = {genotype}")
        out = {}
        if self.test_data is not None:
            x, y = self.test_data
            # whole batches only, as the JAX search counts
            n = len(y) - len(y) % min(self.eval_batch, len(y))
            alphas = self.arch.params
            out["test_acc"] = problem_accuracy(lambda xb: self.classifier(xb, alphas), x[:n],
                                               y[:n], batch=self.eval_batch, device=self.device)
        ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in self.states.items()}
        loss, _, _ = self.arch.eval_loss(ctx, self.arch.cur_batch)
        out["loss"] = loss
        return out


def build_engine(args):
    device = require_device(args.device, "neural_architecture_search")
    test_data = None
    if args.data_dir:
        (x_train, y_train), (x_val, y_val), test_data = split_search_data(args.data_dir)
    else:
        x_train, y_train = make_synthetic_cifar(args.train_size, seed=0)
        x_val, y_val = make_synthetic_cifar(args.train_size, seed=1)

    net = DARTSNetwork(channels=args.channels, layers=args.layers, num_classes=10,
                       device=device, seed=0)
    alphas = init_alphas(torch.Generator().manual_seed(1), device=device)
    arch = Arch(
        name="arch",
        module=from_fn(lambda p: p, alphas),
        optimizer=optim.adam(lr=args.arch_lr, betas=(0.5, 0.999), weight_decay=1e-3),
        train_data_loader=BatchLoader(x_val, y_val, args.batch_size, seed=1),
        config=Config(type="darts", unroll_steps=1, log_step=args.log_step),
    )
    classifier = Classifier(
        name="classifier",
        module=from_torch(net),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9, weight_decay=3e-4,
                            schedule=optim.cosine_lr(args.lr, args.train_iters, 1e-3)),
        train_data_loader=BatchLoader(x_train, y_train, args.batch_size, seed=0),
        config=Config(type="darts", unroll_steps=args.unroll_steps, log_step=args.log_step),
    )
    config = EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                          roll_back=True, compile_blocks=args.compile_blocks,
                          checkpoint_step=args.checkpoint_step,
                          checkpoint_dir=args.checkpoint_dir)
    engine = SearchEngine(config=config, problems=[arch, classifier],
                          dependencies={"u2l": {arch: [classifier]},
                                        "l2u": {classifier: [arch]}},
                          device=device)
    engine.test_data = test_data
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.025)
    p.add_argument("--arch_lr", type=float, default=3e-4)
    p.add_argument("--unroll_steps", type=int, default=1)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--valid_step", type=int, default=50)
    p.add_argument("--train_size", type=int, default=1024)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="CIFAR-10 pickle directory or npz; synthetic if unset")
    p.add_argument("--genotype-out", dest="genotype_out", type=str, default=None,
                   help="write the final genotype as JSON (read by examples/nas_eval.py)")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="directory of the engine checkpoints (with --checkpoint_step)")
    p.add_argument("--checkpoint_step", type=int, default=0,
                   help="save an engine checkpoint every N global steps")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    engine.run()
    genotype = derive_genotype(engine.arch.params)
    print("final genotype:", genotype)
    if args.genotype_out:
        Path(args.genotype_out).write_text(genotype_to_json(genotype))
        print("wrote", args.genotype_out)
    return engine


if __name__ == "__main__":
    main()
