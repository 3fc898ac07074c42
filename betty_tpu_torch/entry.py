"""``entry()``: one forward step of the flagship workload, the
Meta-Weight-Net inner loss over a ResNet-32 classifier (torch counterpart
of ``__graft_entry__.py::entry``).

``entry(device)`` returns ``(forward_step, args)``; ``forward_step(*args)``
is ``mean(mwn(stop_gradient(ce)) * ce)`` at batch 32 with both models in
eval mode (BatchNorm on its running statistics). The weights are random,
made from seeds 0 (ResNet-32) and 1 (MWN); the images and labels are zeros,
as in the JAX entry.
"""

import torch
import torch.nn.functional as F

from betty_tpu_torch.models import MetaWeightNet, ResNet32
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.utils import require_device


def entry(device="cuda"):
    device = require_device(device, "entry")
    batch = 32
    images = torch.zeros(batch, 32, 32, 3, device=device)
    labels = torch.zeros(batch, dtype=torch.int64, device=device)
    resnet = from_torch(ResNet32(10, device=device, seed=0))
    mwn = from_torch(MetaWeightNet(device=device,
                                   generator=torch.Generator(device=device).manual_seed(1)))

    def forward_step(resnet_vars, mwn_vars, images, labels):
        logits = resnet.apply(resnet_vars, images, train=False)
        ce = F.cross_entropy(logits, labels, reduction="none")
        weight = mwn.apply(mwn_vars, ce.detach(), train=False)
        return torch.mean(weight * ce)

    return forward_step, (resnet.variables, mwn.variables, images, labels)
