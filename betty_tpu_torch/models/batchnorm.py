"""Functional BatchNorm with flax's semantics (``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`` in ``betty_tpu/models/resnet.py``).

Train mode normalizes with the batch mean and the biased batch variance over
every axis but the channels (N, H, W of an NCHW input); eval mode with the
running statistics. The running statistics are never written in place: a
train-mode forward given an ``updates`` dict puts the new values there,
``momentum * old + (1 - momentum) * batch`` with the biased variance, keyed
by ``(module, buffer name)``; ``betty_tpu_torch.module.from_torch`` returns
them as the ``"batch_stats"`` collection. (``F.batch_norm`` with running
tensors in train mode would update them in place, with the unbiased
variance.)

``affine=False`` (flax ``use_scale=False, use_bias=False``, the DARTS
search's BatchNorms) has no weight and no bias parameter.
"""

import torch
from torch import nn
import torch.nn.functional as F


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5, device=None,
                 affine: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(features, device=device))
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, train: bool = True, updates=None):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        if updates is not None:
            dims = [d for d in range(x.dim()) if d != 1]
            with torch.no_grad():
                var, mean = torch.var_mean(x.detach(), dim=dims, correction=0)
            m = self.momentum
            updates[(self, "running_mean")] = m * self.running_mean + (1 - m) * mean
            updates[(self, "running_var")] = m * self.running_var + (1 - m) * var
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
