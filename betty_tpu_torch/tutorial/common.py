"""Shared pieces of the tutorials (``tutorial/common.py``): an imbalanced
two-class task of 28x28 inputs (synthetic: the JAX tutorials' numpy
prototypes and draws, so the arrays are equal), its loader, and the two
problems of the reweighting program with their modules.

``Classifier`` (the lower level) weights each example's cross-entropy by
the sigmoid of ``Reweight``'s output for that loss; ``Reweight`` (the upper
level) takes the classifier's cross-entropy and accuracy on balanced meta
data. Labels are int32, as JAX's; the losses take them as int64.
"""

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import ImplicitProblem
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.models import MLP
from betty_tpu_torch.module import from_torch

# class prototypes fixed across splits: train, meta and test data are draws
# from the same task
_PROTOS = np.random.RandomState(12345).randn(2, 784)


def make_imbalanced_mnist(n=2048, imbalance=20, seed=0):
    """``(x float32 [n, 784], y int32 [n])``: two classes, the minority
    ``n // (imbalance + 1)`` examples. ``seed`` varies the examples and the
    imbalance draw, not the task."""
    rng = np.random.RandomState(seed)
    n_minor = n // (imbalance + 1)
    y = np.concatenate([np.ones(n_minor), np.zeros(n - n_minor)])
    rng.shuffle(y)
    x = _PROTOS[y.astype(int)] + rng.randn(n, 784)
    return x.astype(np.float32), y.astype(np.int32)


class Loader(ArrayLoader):
    def __init__(self, x, y, batch_size, seed=0, device=False, shuffle=True):
        super().__init__(x, y, batch_size=batch_size, seed=seed, device=device, shuffle=shuffle)


class Reweight(ImplicitProblem):
    """Upper level: learn per-example weights from balanced meta data."""

    def training_step(self, batch):
        inputs, labels = batch
        labels = labels.long()
        outputs = self.classifier(inputs)
        loss = F.cross_entropy(outputs, labels)
        acc = (outputs.argmax(dim=1) == labels).float().mean() * 100
        return {"loss": loss, "acc": acc}


class Classifier(ImplicitProblem):
    """Lower level: classifier with meta-learned example weights."""

    def training_step(self, batch):
        inputs, labels = batch
        outputs = self.module(inputs)
        ce = F.cross_entropy(outputs, labels.long(), reduction="none")
        weights = torch.sigmoid(self.reweight(ce.detach()[:, None]).squeeze(-1))
        return torch.mean(weights * ce)


def _mlp(in_features, features, rng_seed, device):
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(rng_seed)
    return from_torch(MLP(in_features, features, device=device, generator=generator))


def classifier_module(batch_size, rng_seed=0, device="cuda"):
    """``MLP([128, 2])`` on 784 inputs, its weights drawn from a generator on
    ``device`` seeded with ``rng_seed`` (``batch_size`` is the JAX builder's
    sample batch; the port needs none)."""
    return _mlp(784, [128, 2], rng_seed, device)


def reweight_module(batch_size, rng_seed=1, device="cuda"):
    """``MLP([100, 1])`` on one input (an example's loss)."""
    return _mlp(1, [100, 1], rng_seed, device)
