"""ImageNet data pruning with an EMA teacher (bilevel reweighting).

Port of ``examples/imagenet_pruning/main.py``: a Meta-Weight-Net reweighter
(two input features, Adam at lr 1e-4) over a bottleneck ResNet student
(``ResNetV1``, ResNet-50 at the defaults: 25,557,032 parameters at 1,000
classes; SGD at ``--lr``, momentum 0.9, weight decay 1e-4, ``unroll_steps``
1, ``gradient_accumulation`` ``--gas``), darts hypergradient. The student's
loss weighs each example's cross-entropy by the reweighter's output on
``[cross-entropy, teacher consistency]`` (both detached), where the
consistency is the squared distance between the student's softmax and an
EMA teacher's. The teacher lives in the classifier's state ``extra``
(``teacher_params``): it starts as a copy of the student, runs through
``module_fn.apply`` in eval mode on the bound context's running statistics,
and ``param_callback`` moves it by ``--ema_decay`` inside the optimizer step,
so it travels with checkpoints and compiled blocks.

Synthetic ImageNet-shaped data by default (numpy, seeded as the JAX
example's); ``--device_data`` keeps the sets on the device and draws the
synthetic ones there from a seeded ``torch.Generator`` (a stream of the
port's own, not ``jax.random``'s); ``--data-dir`` reads a classification
npz (``x_train/y_train/x_test/y_test``) with a meta split of ``--meta_size``
examples and top-1 validation. ``--augment device`` runs the reference's
torchvision pipelines inside the step (``betty_tpu_torch/data/augment.py``):
the classifier's loss crops, flips and normalizes from its step seed, the
reweighter's loss and validation take the deterministic resize and center
crop, at ``--crop_size``. ``Classifier.draws``, when set, is ``(rng, images)
-> draws`` and replaces the crop and flip draws (tests inject JAX's).
``--precision bf16`` runs the steps in bfloat16 (BatchNorm statistics in
float32). ``--compile_blocks`` runs the steady schedule as compiled blocks.
``--strategy dp|distributed|zero|fsdp`` runs one process a rank
(``torchrun``), each loading ``--batch_size`` examples, with the global
batch's BatchNorm statistics and crop and flip draws; ``tp`` needs a
model axis on the mesh, which this example does not lay out: it raises.

    python -m betty_tpu_torch.examples.imagenet_pruning --device_data
    python -m betty_tpu_torch.examples.imagenet_pruning --device cpu --batch_size 4 \\
        --image_size 32 --num_classes 10 --width 8 --stages 1 1 --gas 2 --train_size 32 \\
        --meta_size 16 --train_iters 4
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.data import ArrayLoader, imagenet_eval_transform, imagenet_train_transform
from betty_tpu_torch.examples.vision_data import load_classification, problem_accuracy
from betty_tpu_torch.models import MetaWeightNet, ResNetV1
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.problems import problem as problem_mod
from betty_tpu_torch.utils import require_device, seeded_generator, tree_map


def make_synthetic_imagenet(n, num_classes, size, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, size, size, 3).astype(np.float32)
    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    return x, y


def device_synthetic_imagenet(n, num_classes, size, seed, device):
    """Standard-normal images and uniform labels drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (no host transfer)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, size, size, 3), generator=gen, device=device)
    y = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    return x, y


class Loader(ArrayLoader):
    """Epoch-seeded minibatches, labels int64; ``device`` keeps the arrays
    on the device (batches become device gathers)."""

    def __init__(self, x, y, batch_size, seed=0, device=False):
        y = y.long() if isinstance(y, torch.Tensor) else np.asarray(y, np.int64)
        super().__init__(x, y, batch_size=batch_size, seed=seed, device=device)


class Reweight(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        if self.cfg.get("augment"):
            # the held-out meta split takes the deterministic eval transform
            inputs = imagenet_eval_transform(inputs, out_size=self.cfg["crop_size"])
        return F.cross_entropy(self.classifier(inputs), labels)


class Classifier(ImplicitProblem):
    """Student with an EMA teacher in this problem's state ``extra``."""

    draws = None

    def training_step(self, batch):
        inputs, labels = batch
        if self.cfg.get("augment"):
            rng = self.rng
            draws = None if self.draws is None else self.draws(rng, inputs)
            gen = seeded_generator(rng, inputs.device) if draws is None else None
            inputs = imagenet_train_transform(inputs, gen, out_size=self.cfg["crop_size"],
                                              draws=draws)
        logits = self.module(inputs)
        ce = F.cross_entropy(logits, labels, reduction="none")

        extra = self._extra()
        stats = {k: v for k, v in extra.items() if k != "teacher_params"}
        teacher_logits = self.module_fn.apply({"params": extra["teacher_params"], **stats},
                                              inputs, train=False, mutable=())
        consistency = torch.sum((F.softmax(logits, dim=1) - F.softmax(teacher_logits, dim=1))
                                ** 2, dim=1)
        features = torch.stack([ce.detach(), consistency.detach()], dim=1)
        weight = self.reweight(features)
        return torch.mean(weight * ce)

    def _extra(self):
        """This problem's ``extra``: the bound context's inside a loss or a
        hook, the engine state's otherwise."""
        ctx = problem_mod._TRACE_CTX
        if ctx is not None and self.name in ctx:
            return ctx[self.name]["extra"]
        return self.state["extra"]

    def init_state(self, rng=None):
        state = super().init_state(rng)
        # the teacher starts as a copy of the student, never an alias
        teacher = {k: v.clone() for k, v in state["params"].items()}
        state["extra"] = {**state["extra"], "teacher_params": teacher}
        return state

    def param_callback(self):
        """The EMA step, inside the optimizer step on the bound context."""
        decay = self.cfg["ema_decay"]
        extra = self._extra()
        teacher = tree_map(lambda t, s: decay * t + (1 - decay) * s, extra["teacher_params"],
                           self.params)
        ctx = dict(problem_mod._TRACE_CTX)
        ctx[self.name] = {**ctx[self.name], "extra": {**extra, "teacher_params": teacher}}
        problem_mod._TRACE_CTX = ctx


class PruneEngine(Engine):
    """Top-1 accuracy on the test set, when there is one (``--data-dir``);
    under ``--augment device`` each batch takes the eval transform first."""

    test_data = None
    eval_crop = None

    def validation(self):
        if self.test_data is None:
            return {}
        x, y = self.test_data
        fwd = self.classifier
        if self.eval_crop is not None:
            crop = self.eval_crop

            def fwd(xb):  # noqa: F811: the eval transform on the device, per batch
                return self.classifier(imagenet_eval_transform(xb, out_size=crop))
        return {"top1": problem_accuracy(fwd, x, y, device=self.device)}


def build_engine(args):
    device = require_device(args.device, "imagenet_pruning")
    if args.strategy in parallel.DP_STRATEGIES:
        parallel.maybe_init_distributed(device)  # this rank's card, before anything is built
    test_data = None
    if args.data_dir:
        x_train, y_train, x_test, y_test = load_classification(args.data_dir)
        # a meta split held out of the train set drives the pruning scores
        meta_idx = np.random.RandomState(0).permutation(len(y_train))[:args.meta_size]
        mask = np.ones(len(y_train), bool)
        mask[meta_idx] = False
        x_meta, y_meta = x_train[meta_idx], y_train[meta_idx]
        x_train, y_train = x_train[mask], y_train[mask]
        args.image_size = x_train.shape[1]
        args.num_classes = int(y_train.max()) + 1
        test_data = (x_test, y_test)
    elif args.device_data:
        x_train, y_train = device_synthetic_imagenet(args.train_size, args.num_classes,
                                                     args.image_size, 0, device)
        x_meta, y_meta = device_synthetic_imagenet(args.meta_size, args.num_classes,
                                                   args.image_size, 1, device)
    else:
        x_train, y_train = make_synthetic_imagenet(args.train_size, args.num_classes,
                                                   args.image_size, seed=0)
        x_meta, y_meta = make_synthetic_imagenet(args.meta_size, args.num_classes,
                                                 args.image_size, seed=1)

    augment = args.augment == "device"
    aug_cfg = {"augment": True, "crop_size": args.crop_size} if augment else {}
    loader_device = device if args.device_data else False
    student = ResNetV1(stage_sizes=tuple(args.stages), num_classes=args.num_classes,
                       width=args.width, device=device, seed=0)
    mwn = MetaWeightNet(in_features=2, device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    reweight = Reweight(
        name="reweight", module=from_torch(mwn), optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, args.batch_size, seed=1, device=loader_device),
        config=Config(type="darts", log_step=args.log_step, precision=args.precision),
        extra_config=aug_cfg)
    classifier = Classifier(
        name="classifier", module=from_torch(student),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9, weight_decay=1e-4),
        train_data_loader=Loader(x_train, y_train, args.batch_size, seed=0,
                                 device=loader_device),
        config=Config(type="darts", unroll_steps=1, gradient_accumulation=args.gas,
                      log_step=args.log_step, precision=args.precision),
        extra_config={"ema_decay": args.ema_decay, **aug_cfg})
    engine = PruneEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                            compile_blocks=args.compile_blocks, strategy=args.strategy),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device)
    engine.test_data = test_data
    if augment:
        engine.eval_crop = args.crop_size
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--stages", type=int, nargs="+", default=[3, 4, 6, 3])
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--gas", type=int, default=1)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--train_size", type=int, default=256)
    p.add_argument("--meta_size", type=int, default=128)
    p.add_argument("--train_iters", type=int, default=10)
    p.add_argument("--valid_step", type=int, default=1000)
    p.add_argument("--strategy", default="default",
                   help="default, or a data-parallel strategy over torch.distributed: dp "
                        "(alias distributed), zero, fsdp; tp raises (no model axis here)")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="classification npz (x_train/y_train/x_test/y_test)")
    p.add_argument("--augment", choices=["none", "device"], default="none",
                   help="'device': the torchvision train/eval pipelines inside the step "
                        "(betty_tpu_torch/data/augment.py)")
    p.add_argument("--crop_size", type=int, default=224,
                   help="model input size under --augment device")
    p.add_argument("--device_data", action="store_true",
                   help="keep the datasets on the device (synthetic ones drawn there)")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
