"""The Omniglot few-shot CNN (``betty_tpu/models/omniglot.py``), the iMAML
backbone: 4 x (3x3 SAME convolution with bias, BatchNorm with momentum 0.9
and eps 1e-5, ReLU, 2x2 max pool of stride 2 with flax's default VALID
padding), flattened in flax's NHWC order, then a linear head. At 28x28 the
map goes 28 -> 14 -> 7 -> 3 -> 1 (SAME pools would give 2x2 after the
fourth pool).

Inputs are NHWC images as in the JAX package; the model views them as
NCHW. BatchNorm is ``models/batchnorm.py``'s (running statistics through
``updates``). ``convert.from_flax_omniglot`` carries the JAX package's
variables over. Parameter names: ``convs.i.{weight,bias}``,
``norms.i.{weight,bias}`` (statistics ``norms.i.running_{mean,var}``),
``head.{weight,bias}``.
"""

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.batchnorm import BatchNorm
from betty_tpu_torch.models.layers import Conv, max_pool
from betty_tpu_torch.models.mlp import dense


class OmniglotCNN(nn.Module):
    def __init__(self, num_classes: int = 5, hidden: int = 64, in_channels: int = 1,
                 image: int = 28, device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        widths = [in_channels] + [hidden] * 4
        self.convs = nn.ModuleList(Conv(a, b, 3, 1, device, gen, use_bias=True)
                                   for a, b in zip(widths[:-1], widths[1:]))
        self.norms = nn.ModuleList(BatchNorm(hidden, momentum=0.9, eps=1e-5, device=device)
                                   for _ in range(4))
        side = image
        for _ in range(4):
            side //= 2  # VALID 2x2 pools of stride 2
        self.head = dense(hidden * side * side, num_classes, device, gen)

    def forward(self, x, train: bool = True, rngs=None, updates=None):
        """``x``: (N, H, W, C) images; returns (N, num_classes) logits."""
        x = x.permute(0, 3, 1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = max_pool(F.relu(norm(conv(x), train, updates)), 2, 2, padding="VALID")
        return self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
