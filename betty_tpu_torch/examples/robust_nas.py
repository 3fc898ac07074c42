"""Robust NAS (DSRNA-style): the DARTS search whose classifier loss adds
input-Jacobian and curvature regularizers.

Port of ``examples/robust_nas/main.py``. The arch problem holds the alphas
and its loss is the supernet's cross-entropy on its batch, as in
``examples/neural_architecture_search.py``; the classifier's loss adds

    lambda_j * jacobian_reg + lambda_c * cure_reg,

functions of the loss's gradient with respect to the classifier's
*inputs*, and the engine differentiates that loss with respect to the
parameters (and darts' two perturbed evaluations with respect to the
alphas): a second-order pass through the inputs. A zero coefficient skips
its term. ``curvature_reg`` (the power-iteration eigenvalue of the input
Hessian) is the monitor, not a training term, as in the JAX example.

The input gradients are ``torch.autograd.grad(..., create_graph=True)``
of the loss at the batch: the classifier's own forward (the one that keeps
the running statistics) serves the loss, the Jacobian term and CURE's
gradient at ``x``, where the JAX example takes a JVP and a ``jax.grad``
of the same function of the same inputs, each with its own forward. The
other forwards (CURE's at ``x + z``) normalize with their own batch
statistics, as flax's train-mode apply does, and keep none.

The defaults are the JAX example's: the DARTS search widths (C16, 8 cells,
B32), SGD 0.025 with momentum 0.9 and weight decay 3e-4 (no schedule),
Adam 3e-4 with betas (0.5, 0.999) and weight decay 1e-3 on the alphas,
unroll 1, no roll-back, ``lambda_j`` 0.1, ``lambda_c`` 0.01, synthetic
CIFAR-shaped data. ``--arch mlp`` is the light backbone (``MixMLP``).
``--data-dir`` reads a local CIFAR-10 copy (the pickle directory or an
npz) split as the DARTS search splits it (first half of the train set for
the weights, second half for the architecture), and each validation
reports ``test_acc`` on its test set.

    python -m betty_tpu_torch.examples.robust_nas
    python -m betty_tpu_torch.examples.robust_nas --device cpu --channels 2 --layers 1 \\
        --batch_size 4 --train_size 16 --train_iters 2

``--compile_blocks`` runs the steady schedule as compiled blocks (on CUDA
one graph replay a meta-period, the Jacobian directions' generator in the
graph's reseeded pool); ``--checkpoint_dir`` with ``--checkpoint_step``
saves engine checkpoints there.
"""

import argparse

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.examples.learning_to_reweight import BatchLoader, make_synthetic_cifar
from betty_tpu_torch.examples.neural_architecture_search import split_search_data
from betty_tpu_torch.examples.vision_data import problem_accuracy
from betty_tpu_torch.models.darts import DARTSNetwork, derive_genotype, init_alphas
from betty_tpu_torch.models.mlp import ACTIVATIONS, dense
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.parallel import local_rows
from betty_tpu_torch.utils import fold_in, require_device, seeded_generator

DIRECTION_FOLD = 0x4A4143  # the Jacobian direction's generator: fold_in(rng, this)
CURVATURE_FOLD = 0x4356  # the power iteration's start


def input_grad(loss_fn, x):
    """``(L(x), dL/dx)`` with the gradient's graph kept (a differentiable
    function of whatever ``loss_fn`` depends on); ``x`` becomes a leaf."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(x)
        (g,) = torch.autograd.grad(loss, x, create_graph=True)
    return loss, g


def _unit(u):
    """``u`` over its norm across the whole global batch (every rank's rows
    under a data-parallel mesh)."""
    return u / (torch.sqrt(parallel.global_sum(torch.sum(u ** 2))) + 1e-12)


def _randn(rng, fold, like):
    """A draw shaped like ``like``: this rank's rows of the global batch's
    draw under a data-parallel mesh."""
    gen = seeded_generator(fold_in(rng, fold), like.device)
    return local_rows(like.shape, lambda shape: torch.randn(
        shape, generator=gen, dtype=like.dtype, device=like.device))


def jacobian_reg(loss_fn, x, rng, direction=None, grad=None):
    """``(J_x L . u)^2`` for one random direction ``u`` normalized over the
    whole tensor (an estimator of the input-Jacobian's squared norm).

    For a scalar loss ``J_x L . u = <dL/dx, u>``: the port takes the
    create-graph input gradient (``grad``, when the caller already has it)
    and dots it with ``u``, where JAX takes one ``jax.jvp``. ``u`` is drawn
    from a generator seeded ``fold_in(rng, DIRECTION_FOLD)``
    (``utils.seeded_generator``: inside a compiled block the graph's
    reseeded pool), not JAX's threefry draw; ``direction`` replaces the
    draw (tests inject JAX's)."""
    if grad is None:
        _, grad = input_grad(loss_fn, x)
    u = _randn(rng, DIRECTION_FOLD, x) if direction is None else direction.to(x)
    # a rank's input gradient is world x the global batch's on its rows
    return parallel.global_mean(torch.sum(grad * _unit(u))) ** 2


def cure_reg(loss_fn, x, h=1.0, grad=None):
    """CURE's finite-difference curvature penalty (what DSRNA trains with):
    ``z = h * sign(g) / ||sign(g)||`` per example, ``g = dL/dx`` detached
    (``sign(0) = 0``), and the penalty ``mean ||dL/dx(x + z) - dL/dx(x)||``,
    with JAX's 1e-12 under both square roots. ``grad`` is the create-graph
    ``dL/dx`` at ``x`` when the caller has it."""
    if grad is None:
        _, grad = input_grad(loss_fn, x)
    z = torch.sign(grad.detach())
    lead = (-1,) + (1,) * (z.dim() - 1)
    norm = torch.sqrt(torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=1) + 1e-12)
    z = h * z / norm.reshape(lead)
    _, shifted = input_grad(loss_fn, x.detach() + z)
    diff = (shifted - grad) * parallel.rank_share()  # the global objective's input gradients
    return torch.mean(torch.sqrt(torch.sum(diff.reshape(diff.shape[0], -1) ** 2, dim=1)
                                 + 1e-12))


def curvature_reg(loss_fn, x, rng, iters=5, direction=None):
    """The largest eigenvalue of the input Hessian by power iteration
    (DSRNA's curvature monitor): ``v <- Hv / ||Hv||`` from a random unit
    ``v``, then ``<v, Hv>``. The HVPs are double backwards of one
    create-graph input gradient (the input Hessian is symmetric); the
    converged ``v`` is detached, so the result is differentiable with
    respect to the parameters through ``H`` alone. ``v`` is drawn from a
    generator seeded ``fold_in(rng, CURVATURE_FOLD)``; ``direction``
    replaces the draw."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(x), x, create_graph=True)

        def hvp(v, create_graph):
            return torch.autograd.grad(g, x, grad_outputs=v, retain_graph=True,
                                       create_graph=create_graph)[0]

        v = _randn(rng, CURVATURE_FOLD, x) if direction is None else direction.to(x)
        v = _unit(v)
        for _ in range(iters):
            v = _unit(hvp(v, False).detach() * parallel.rank_share())
        return parallel.global_mean(torch.sum(v * hvp(v, True)))


class Arch(ImplicitProblem):
    def training_step(self, batch):
        inputs, labels = batch
        return F.cross_entropy(self.classifier.module(inputs, self.params), labels)


class Classifier(ImplicitProblem):
    """The supernet's cross-entropy plus the regularizers. ``directions``,
    when set, is ``(rng, x) -> u`` and replaces the Jacobian term's draw
    (tests inject JAX's)."""

    directions = None

    def training_step(self, batch):
        inputs, labels = batch
        alphas = self.arch.params
        lambda_j, lambda_c = self.cfg["lambda_j"], self.cfg["lambda_c"]

        def input_loss(x):
            return F.cross_entropy(self.module(x, alphas), labels)

        rng = self.rng
        if not (lambda_j or lambda_c):
            loss = input_loss(inputs)
            return {"loss": loss, "ce": loss}
        # one forward serves the loss and the input gradient of both terms
        loss, g = input_grad(input_loss, inputs)
        total = loss
        if lambda_j:
            u = None if self.directions is None else self.directions(rng, inputs)
            total = total + lambda_j * jacobian_reg(input_loss, inputs, rng, direction=u,
                                                    grad=g)
        if lambda_c:
            total = total + lambda_c * cure_reg(input_loss, inputs, grad=g)
        return {"loss": total, "ce": loss}


class MixMLP(nn.Module):
    """The light backbone: the first normal edge's first two alphas mix two
    ``Dense(10)`` heads over a tanh-GELU ``Dense(32)`` of the flattened
    image (GELU keeps the input Hessian away from 0, where ReLU's is 0)."""

    def __init__(self, in_features=32 * 32 * 3, device=None, generator=None):
        super().__init__()
        self.dense0 = dense(in_features, 32, device, generator)
        self.dense1 = dense(32, 10, device, generator)
        self.dense2 = dense(32, 10, device, generator)

    def forward(self, x, alphas, train=True, rngs=None):
        w = torch.softmax(alphas["normal"][0, :2], dim=0)
        x = ACTIVATIONS["gelu"](self.dense0(x.reshape(x.shape[0], -1)))
        return w[0] * self.dense1(x) + w[1] * self.dense2(x)


class RobustSearchEngine(Engine):
    """Validation logs the derived genotype and, with a test set, reports
    the supernet's test accuracy under the current alphas."""

    test_data = None  # (x, y) with --data-dir

    def validation(self):
        self.logger.info(f"genotype = {derive_genotype(self.arch.params)}")
        if self.test_data is None:
            return {}
        alphas = self.arch.params
        return {"test_acc": problem_accuracy(lambda xb: self.classifier(xb, alphas),
                                             *self.test_data, device=self.device)}


def build_engine(args):
    device = require_device(args.device, "robust_nas")
    test_data = None
    if args.data_dir:
        (x_train, y_train), (x_val, y_val), test_data = split_search_data(args.data_dir)
    else:
        x_train, y_train = make_synthetic_cifar(args.train_size, seed=0)
        x_val, y_val = make_synthetic_cifar(args.train_size, seed=1)

    if args.arch == "mlp":
        net = MixMLP(device=device, generator=torch.Generator(device=device).manual_seed(0))
    else:
        net = DARTSNetwork(channels=args.channels, layers=args.layers, num_classes=10,
                           device=device, seed=0)
    alphas = init_alphas(torch.Generator().manual_seed(1), device=device)
    arch = Arch(
        name="arch",
        module=from_fn(lambda p: p, alphas),
        optimizer=optim.adam(lr=3e-4, betas=(0.5, 0.999), weight_decay=1e-3),
        train_data_loader=BatchLoader(x_val, y_val, args.batch_size, seed=1),
        config=Config(type="darts", log_step=args.log_step),
    )
    classifier = Classifier(
        name="classifier",
        module=from_torch(net),
        optimizer=optim.sgd(lr=args.lr, momentum=0.9, weight_decay=3e-4),
        train_data_loader=BatchLoader(x_train, y_train, args.batch_size, seed=0),
        config=Config(type="darts", unroll_steps=args.unroll_steps, log_step=args.log_step),
        extra_config={"lambda_j": args.lambda_j, "lambda_c": args.lambda_c},
    )
    config = EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                          compile_blocks=args.compile_blocks,
                          checkpoint_step=args.checkpoint_step,
                          checkpoint_dir=args.checkpoint_dir)
    engine = RobustSearchEngine(config=config, problems=[arch, classifier],
                                dependencies={"u2l": {arch: [classifier]},
                                              "l2u": {classifier: [arch]}},
                                device=device)
    engine.test_data = test_data
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--channels", type=int, default=16)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.025)
    p.add_argument("--unroll_steps", type=int, default=1)
    p.add_argument("--lambda_j", type=float, default=0.1)
    p.add_argument("--lambda_c", type=float, default=0.01)
    p.add_argument("--train_size", type=int, default=1024)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--valid_step", type=int, default=50)
    p.add_argument("--arch", default="darts", choices=["darts", "mlp"],
                   help="mlp = the light backbone (MixMLP)")
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="CIFAR-10 pickle directory or npz; synthetic if unset")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="directory of the engine checkpoints (with --checkpoint_step)")
    p.add_argument("--checkpoint_step", type=int, default=0,
                   help="save an engine checkpoint every N global steps")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    print("genotype:", derive_genotype(engine.arch.params))
    return engine


if __name__ == "__main__":
    main()
