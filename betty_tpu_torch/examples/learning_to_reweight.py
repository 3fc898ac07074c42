"""Learning to reweight (Meta-Weight-Net) on CIFAR-10: the system's flagship.

Port of ``examples/learning_to_reweight/main.py``: a ResNet-32 classifier
(BatchNorm, 466,906 parameters) trained on per-example losses weighted by a
Meta-Weight-Net (100 hidden units), whose hypergradient comes from darts
(default), SAMA, CG or Neumann with ``unroll_steps=1``, fp32. Classifier:
SGD, lr 0.1, momentum 0.9, nesterov, weight decay 5e-4; reweighter: Adam,
lr 1e-5. Images are NHWC, synthetic CIFAR-shaped by default; ``--data-dir``
reads a local CIFAR-10 copy (pickle directory or npz), with
``--imbalanced_factor`` and ``--corruption_type``/``--corruption_ratio``.
``--baseline`` trains the classifier alone on the plain mean loss,
``--export_weights`` saves the reweighter's per-example weights after
training, and ``--retrain`` samples the kept set by them.

    python -m betty_tpu_torch.examples.learning_to_reweight --device_data
    python -m betty_tpu_torch.examples.learning_to_reweight --device cpu \\
        --batch_size 8 --train_size 64 --meta_size 32 --train_iters 4

``--stage_sizes`` cuts the depth (``1,1,1`` is a 3-block ResNet).
``--compile_blocks`` runs the steady schedule as compiled blocks (on CUDA
one graph replay a meta-period; with ``--device_data`` the batches are
gathered inside the graph). ``--checkpoint_dir`` saves an engine
checkpoint whenever the test accuracy improves (``MWNEngine.validation``,
with ``--data-dir``); ``Engine.load_checkpoint`` reads it back.
``--strategy dp|distributed|zero|fsdp`` runs one process a rank
(``torchrun --nproc_per_node N -m betty_tpu_torch.examples.learning_to_reweight
--strategy dp``), each rank loading ``--batch_size`` examples; the
ResNet's BatchNorm then normalizes with the global batch's statistics
(``models/batchnorm.py``). ``tp`` needs a model axis on the mesh, which
this example does not lay out (``examples/bert_data_reweighting.py`` and
``examples/moe_reweighting.py`` do): it raises ``ValueError``.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples.mwn_data import augment_batch, build_splits, load_cifar10
from betty_tpu_torch.examples.vision_data import problem_accuracy
from betty_tpu_torch.models import MetaWeightNet, ResNet
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.utils import require_device


def make_synthetic_cifar(n, num_classes=10, seed=0, image=(32, 32, 3)):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *image).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    return x, y


class BatchLoader(ArrayLoader):
    """Epoch-seeded minibatches; with ``augment``, each train batch is
    cropped and flipped on the host in ``postprocess`` (so it needs host
    arrays, not ``device``)."""

    def __init__(self, x, y, batch_size, seed=0, drop_last=True, device=False, augment=False):
        if augment and device is not False:
            raise ValueError("augmentation runs on the host: drop --device_data")
        super().__init__(x, np.asarray(y, np.int64), batch_size=batch_size, seed=seed,
                         drop_last=drop_last, device=device)
        self.augment = augment
        # without augmentation postprocess passes batches through, so compiled
        # blocks may gather them on the device
        self.postprocess_is_identity = not augment
        self._aug_rng = np.random.RandomState(seed + 77)

    def postprocess(self, batch):
        if self.augment:
            x, y = batch
            return augment_batch(np.asarray(x), self._aug_rng), y
        return batch


class WeightedSampleLoader(BatchLoader):
    """Epoch-seeded sampling with replacement, weighted by per-example
    sample weights (``--retrain``)."""

    def __init__(self, x, y, weights, batch_size, **kw):
        super().__init__(x, y, batch_size=batch_size, **kw)
        w = np.asarray(weights, np.float64).clip(min=0)
        assert len(w) == len(x)
        total = w.sum()
        self.probs = (w / total) if total > 0 else np.full(len(w), 1 / len(w))

    def _epoch_order(self, epoch):
        r = np.random.RandomState(self.seed + epoch)
        return r.choice(self.n, size=self.n, replace=True, p=self.probs)


class Reweight(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        outputs = self.classifier(inputs)
        loss = F.cross_entropy(outputs, labels)
        acc = (outputs.argmax(dim=1) == labels).float().mean() * 100
        return {"loss": loss, "acc": acc}


class Classifier(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        outputs = self.module(inputs)
        ce = F.cross_entropy(outputs, labels, reduction="none")
        weight = self.reweight(ce.detach())
        return torch.mean(weight * ce)


class BaselineClassifier(ImplicitProblem):
    """Uniform-loss single-level training (``--baseline``, ``--retrain``)."""

    def training_step(self, batch):
        inputs, labels = batch
        return F.cross_entropy(self.module(inputs), labels)


class MWNEngine(Engine):
    """Engine whose validation is test accuracy (when a test set exists),
    saving a checkpoint into ``checkpoint_dir`` on each improvement."""

    test_data = None
    checkpoint_dir = None
    eval_batch = 512
    best_acc = -1.0

    def validation(self):
        if self.test_data is None:
            return {}
        x, y = self.test_data
        acc = problem_accuracy(self.classifier, x, y, batch=self.eval_batch)
        if acc > self.best_acc:
            self.best_acc = acc
            if self.checkpoint_dir:
                self.save_checkpoint(self.checkpoint_dir)
        return {"acc": acc, "best_acc": self.best_acc}


def make_schedule(args):
    """Classifier LR schedule: ``--lr_milestones`` (torch ``MultiStepLR``,
    gamma 0.1) or ``--lr_schedule`` (step decay every 10000 steps)."""
    if args.lr_milestones:
        return optim.multistep_lr(args.lr, [int(m) for m in args.lr_milestones.split(",")],
                                  gamma=0.1)
    if args.lr_schedule:
        return optim.step_lr(args.lr, step_size=10000, gamma=0.1)
    return None


def solver_kwargs(args):
    if args.solver == "cg":
        return {"cg_iterations": args.cg_iterations, "cg_alpha": args.cg_alpha}
    if args.solver == "neumann":
        return {"neumann_iterations": args.neumann_iterations,
                "neumann_alpha": args.neumann_alpha}
    return {}


def build_engine(args):
    device = require_device(args.device, "learning_to_reweight")
    if args.strategy in parallel.DP_STRATEGIES:
        parallel.maybe_init_distributed(device)  # this rank's card, before anything is built
    test_data = None
    if args.data_dir:
        x_all, y_all, x_test, y_test = load_cifar10(args.data_dir)
        x_train, y_train, x_meta, y_meta, idx_train = build_splits(
            x_all, y_all, num_classes=args.num_classes, num_meta_total=args.num_meta,
            imbalanced_factor=args.imbalanced_factor, corruption_type=args.corruption_type,
            corruption_ratio=args.corruption_ratio, seed=args.data_seed, return_indices=True)
        base_x = x_all
        test_data = (x_test, y_test)
    else:
        x_train, y_train = make_synthetic_cifar(args.train_size, seed=0)
        x_meta, y_meta = make_synthetic_cifar(args.meta_size, seed=1)
        base_x = x_train
        idx_train = np.arange(len(x_train))

    loader_device = device if args.device_data else False
    if args.retrain:
        saved = np.load(args.reweight_path)
        x_train = base_x[saved["indexes"]]
        y_train = saved["labels"].astype(np.int32)
        train_loader = WeightedSampleLoader(x_train, y_train, saved["weights"],
                                            args.batch_size, seed=0, device=loader_device,
                                            augment=args.augment)
    else:
        train_loader = BatchLoader(x_train, y_train, args.batch_size, seed=0,
                                   device=loader_device, augment=args.augment)
    meta_loader = BatchLoader(x_meta, y_meta, args.batch_size, seed=1, device=loader_device)

    resnet = ResNet(stage_sizes=tuple(int(s) for s in args.stage_sizes.split(",")),
                    num_classes=args.num_classes, device=device, seed=0)
    classifier_opt = optim.sgd(lr=args.lr, momentum=args.momentum,
                               weight_decay=args.weight_decay, nesterov=True,
                               schedule=make_schedule(args))
    engine_config = EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                                 compile_blocks=args.compile_blocks, strategy=args.strategy)

    if args.baseline or args.retrain:
        # one problem, no dependency edges, plain mean cross-entropy
        classifier = BaselineClassifier(
            name="classifier", module=from_torch(resnet), optimizer=classifier_opt,
            train_data_loader=train_loader,
            config=Config(precision=args.precision, log_step=args.log_step))
        engine = MWNEngine(config=engine_config, problems=[classifier],
                           dependencies={"u2l": {}, "l2u": {}}, device=device)
        engine.test_data = test_data
        engine.checkpoint_dir = args.checkpoint_dir
        return engine

    mwn = MetaWeightNet(device=device, generator=torch.Generator(device=device).manual_seed(1))
    reweight = Reweight(
        name="reweight", module=from_torch(mwn),
        optimizer=optim.adam(lr=args.meta_lr, weight_decay=args.meta_weight_decay),
        train_data_loader=meta_loader,
        config=Config(type=args.solver, precision=args.precision, log_step=args.log_step))
    classifier = Classifier(
        name="classifier", module=from_torch(resnet), optimizer=classifier_opt,
        train_data_loader=train_loader,
        config=Config(type=args.solver, unroll_steps=args.unroll_steps,
                      precision=args.precision, log_step=args.log_step, **solver_kwargs(args)))
    engine = MWNEngine(
        config=engine_config, problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device)
    engine.test_data = test_data
    engine.checkpoint_dir = args.checkpoint_dir
    # the kept training set and its base-array indices, for --export_weights
    engine.train_set = (x_train, y_train, idx_train)
    return engine


def export_sample_weights(engine, path, batch=512):
    """Save the reweighter's weight of every kept training example,
    ``meta_net(CE_i)`` at the final classifier parameters, with the set's
    base-array indices and (possibly corrupted) labels: the npz that
    ``--retrain`` reads. Eval mode: BatchNorm uses the running statistics,
    so no example's weight depends on its co-batch."""
    x, y, idx = engine.train_set
    clf, rw = engine.classifier, engine.reweight
    device = clf.device
    spans = [(i, i + batch) for i in range(0, len(x) - batch + 1, batch)]
    if len(x) % batch:
        spans.append((len(x) - len(x) % batch, len(x)))
    engine.eval()
    weights = []
    with torch.no_grad():
        for start, stop in spans:
            xb = torch.from_numpy(np.asarray(x[start:stop])).to(device)
            yb = torch.from_numpy(np.asarray(y[start:stop], np.int64)).to(device)
            ce = F.cross_entropy(clf(xb), yb, reduction="none")
            weights.append(rw(ce).reshape(-1))
    engine.train()
    np.savez(path, weights=torch.cat(weights).cpu().numpy(), indexes=np.asarray(idx),
             labels=np.asarray(y))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--meta_lr", type=float, default=1e-5)
    p.add_argument("--meta_weight_decay", type=float, default=0.0)
    p.add_argument("--solver", type=str, default="darts",
                   choices=["darts", "sama", "cg", "neumann"])
    p.add_argument("--cg_iterations", type=int, default=3)
    p.add_argument("--cg_alpha", type=float, default=1.0)
    p.add_argument("--neumann_iterations", type=int, default=5)
    p.add_argument("--neumann_alpha", type=float, default=0.01)
    p.add_argument("--unroll_steps", type=int, default=1)
    p.add_argument("--precision", type=str, default="fp32")
    p.add_argument("--strategy", type=str, default="default",
                   help="default, or a data-parallel strategy over torch.distributed: dp "
                        "(alias distributed), zero, fsdp; tp raises (no model axis here)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--stage_sizes", type=str, default="5,5,5",
                   help="blocks per stage of the ResNet (5,5,5: ResNet-32)")
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--valid_step", type=int, default=1000)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--lr_schedule", action="store_true")
    p.add_argument("--lr_milestones", type=str, default=None,
                   help="comma-separated steps of a MultiStepLR, e.g. '10000,13000'")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device_data", action="store_true",
                   help="keep the datasets on the device and gather batches there")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="CIFAR-10 pickle dir or npz; synthetic if unset")
    p.add_argument("--num_meta", type=int, default=1000)
    p.add_argument("--imbalanced_factor", type=float, default=None)
    p.add_argument("--corruption_type", type=str, default=None,
                   choices=["uniform", "flip1", "flip2"])
    p.add_argument("--corruption_ratio", type=float, default=0.0)
    p.add_argument("--data_seed", type=int, default=1)
    p.add_argument("--augment", action="store_true",
                   help="host-side random crop + flip on train batches")
    p.add_argument("--baseline", action="store_true",
                   help="single-level uniform-loss training (no reweighter)")
    p.add_argument("--retrain", action="store_true",
                   help="single-level retrain on the kept set, sampling weighted by saved "
                        "per-example weights")
    p.add_argument("--reweight_path", type=str, default="reweight.npz",
                   help="npz with weights/indexes/labels (see --export_weights)")
    p.add_argument("--export_weights", type=str, default=None,
                   help="after bilevel training, save the per-example weights npz")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="save an engine checkpoint on validation improvement")
    p.add_argument("--train_size", type=int, default=4096)
    p.add_argument("--meta_size", type=int, default=1024)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    engine.run()
    if args.export_weights and not (args.baseline or args.retrain):
        export_sample_weights(engine, args.export_weights)
    if engine.test_data is not None:
        print(f"IF {args.imbalanced_factor} || Best Acc.: {engine.best_acc}")
    return engine


if __name__ == "__main__":
    main()
