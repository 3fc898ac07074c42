"""Meta-Weight-Net reweighter (``betty_tpu/models/mlp.py``).

Parameters are ``dense0.weight/bias`` and ``dense1.weight/bias`` in
``nn.Linear``'s (out, in) layout; ``betty_tpu_torch.convert`` maps flax's
``Dense_0``/``Dense_1`` onto them.
"""

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.init import lecun_normal_


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
