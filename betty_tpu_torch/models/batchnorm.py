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
``scale_init="zeros"`` (flax ``scale_init=nn.initializers.zeros``, the last
BatchNorm of a bottleneck block) starts the weight at 0 instead of 1.

A bfloat16 or float16 input (``precision="bf16"``) has its statistics
taken in float32, and the running statistics it reports are float32, as
flax's ``force_float32_reductions`` gives them.

Under a data-parallel mesh (``parallel.current()``, bound by the problem's
update) a train-mode forward normalizes with the statistics of the global
batch, as JAX's BatchNorm over a dp-sharded batch does: the per-channel
sums, sums of squares and counts go through the differentiable all-reduce
(``parallel.global_sum``), the variance is flax's ``E[x^2] - E[x]^2``
(clipped at 0), and the normalization is computed here from them, so its
gradient (and its double backward) reaches every rank's examples; the
running statistics are the global ones. ``nn.SyncBatchNorm`` is not used:
it updates buffers in place and has no double backward.
"""

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch import parallel


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5, device=None,
                 affine: bool = True, scale_init: str = "ones"):
        super().__init__()
        if scale_init not in ("ones", "zeros"):
            raise ValueError(f"scale_init {scale_init!r}: 'ones' or 'zeros'")
        self.momentum = momentum
        self.eps = eps
        self.weight = self.bias = None
        if affine:
            init = torch.ones if scale_init == "ones" else torch.zeros
            self.weight = nn.Parameter(init(features, device=device))
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x, train: bool = True, updates=None):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                training=False, eps=self.eps)
        if parallel.current() is not None:
            return self._global_forward(x, updates)
        if updates is not None:
            dims = [d for d in range(x.dim()) if d != 1]
            stats_x = x.detach()
            if stats_x.dtype in (torch.bfloat16, torch.float16):
                stats_x = stats_x.float()
            with torch.no_grad():
                var, mean = torch.var_mean(stats_x, dim=dims, correction=0)
            m = self.momentum
            updates[(self, "running_mean")] = m * self.running_mean + (1 - m) * mean
            updates[(self, "running_var")] = m * self.running_var + (1 - m) * var
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)

    def _global_forward(self, x, updates):
        """Train mode on the global batch of the bound mesh."""
        dims = [d for d in range(x.dim()) if d != 1]
        xs = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        count = torch.full((1,), float(xs.numel() // xs.shape[1]), dtype=xs.dtype,
                           device=xs.device)
        sums = parallel.global_sum(torch.cat([xs.sum(dim=dims), (xs * xs).sum(dim=dims),
                                              count]))
        c = xs.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        if updates is not None:
            m = self.momentum
            updates[(self, "running_mean")] = m * self.running_mean + (1 - m) * mean.detach()
            updates[(self, "running_var")] = m * self.running_var + (1 - m) * var.detach()
        shape = [1, c] + [1] * (x.dim() - 2)
        y = (xs - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)
