"""MLPs, including the Meta-Weight-Net reweighter (``betty_tpu/models/mlp.py``).

``MLP`` is a stack of linear layers, ``layers.i.weight/bias`` in
``nn.Linear``'s (out, in) layout, with an activation between them and none
after the last; ``betty_tpu_torch.convert.from_flax_mlp`` maps flax's
``Dense_i`` onto them. ``activation`` names a flax activation, computed as
flax computes it: ``gelu`` is the tanh approximation, ``softplus`` is
``logaddexp(x, 0)`` with no threshold.

``MetaWeightNet``'s parameters are ``dense0.weight/bias`` and
``dense1.weight/bias``; ``convert.from_flax_mwn`` maps flax's
``Dense_0``/``Dense_1`` onto them.

Linear layers take flax's default initialization (lecun-normal kernels,
zero biases) from an explicit ``torch.Generator``.
"""

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.init import lecun_normal_


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# flax.linen's activations by name
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    "softplus": softplus,
    "leaky_relu": F.leaky_relu,
}


def dense(in_features, out_features, device=None, generator=None):
    """An ``nn.Linear`` with flax ``Dense``'s initialization."""
    layer = nn.Linear(in_features, out_features, device=device)
    lecun_normal_(layer.weight, fan_in=in_features, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    """flax ``MLP(features, activation)``; ``in_features`` is the width of
    the input's last axis (flax infers it from the sample input)."""

    def __init__(self, in_features: int, features: Sequence[int], activation: str = "relu",
                 device=None, generator: torch.Generator = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; one of {sorted(ACTIVATIONS)}")
        self.activation = activation
        widths = [in_features, *features]
        self.layers = nn.ModuleList(dense(a, b, device, generator)
                                    for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x, train: bool = True, rngs=None):
        act = ACTIVATIONS[self.activation]
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = act(x)
        return x


class MetaWeightNet(nn.Module):
    """loss value(s) -> per-example weight in (0, 1)."""

    def __init__(self, hidden: int = 100, in_features: int = 1, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        self.in_features = in_features
        self.dense0 = nn.Linear(in_features, hidden, device=device)
        self.dense1 = nn.Linear(hidden, 1, device=device)
        for layer in (self.dense0, self.dense1):
            lecun_normal_(layer.weight, fan_in=layer.in_features, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, loss_values, train: bool = True, rngs=None):
        x = loss_values.reshape(-1, self.in_features)
        x = F.relu(self.dense0(x))
        return torch.sigmoid(self.dense1(x)).reshape(-1)
