"""Convolution and pooling with flax's padding, on NCHW tensors.

Shared by ``models/resnet.py`` and ``models/darts.py``. flax's ``"SAME"``
pads ``max((ceil(n / s) - 1) * s + k_eff - n, 0)`` along an axis of size
``n``, the smaller half before, where ``k_eff = (k - 1) * dilation + 1``:
a stride-2 convolution of an even input pads asymmetrically (3x3 on 32:
(0, 1); 5x5: (1, 2); a 3x3 of dilation 2, effective 5: (1, 2); a 5x5 of
dilation 2, effective 9: (3, 4)), which ``F.conv2d``'s symmetric
``padding`` cannot express, so those inputs are padded first.

``max_pool`` pads with -inf. ``avg_pool`` pads with zeros and counts them
(flax's ``avg_pool`` defaults to ``count_include_pad=True``), so a 3x3
SAME average divides by 9 everywhere, the border and the stride-2 (0, 1)
padding included.
"""

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.init import lecun_normal_


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """(before, after) padding of flax's ``"SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, dilation=1, value=0.0):
    """``x`` padded as SAME, or ``(x, symmetric pads)`` for the callee to
    pad when both axes are symmetric."""
    ph = same_pads(x.shape[2], kernel, stride, dilation)
    pw = same_pads(x.shape[3], kernel, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), kernel_dilation=(d, d),
    feature_group_count=groups, padding=padding, use_bias=False)`` on NCHW;
    the weight is ``(features, in_features // groups, k, k)``."""

    def __init__(self, in_features, features, kernel, stride=1, device=None, generator=None,
                 dilation=1, groups=1, padding="SAME"):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.groups = groups
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel,
                                               device=device))
        lecun_normal_(self.weight, fan_in=in_features // groups * kernel * kernel,
                      generator=generator)

    def forward(self, x):
        pads = (0, 0)
        if self.padding == "SAME":
            x, pads = _pad_same(x, self.weight.shape[-1], self.stride, self.dilation)
        return F.conv2d(x, self.weight, stride=self.stride, padding=pads,
                        dilation=self.dilation, groups=self.groups)


def max_pool(x, window: int, stride: int):
    """flax ``nn.max_pool(x, (w, w), (s, s), padding="SAME")`` on NCHW."""
    x, pads = _pad_same(x, window, stride, value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=pads)


def avg_pool(x, window: int, stride: int, padding: str = "SAME"):
    """flax ``nn.avg_pool(x, (w, w), (s, s), padding=padding)`` on NCHW: the
    padded zeros count, every window divides by w * w."""
    pads = (0, 0)
    if padding == "SAME":
        x, pads = _pad_same(x, window, stride)
    return F.avg_pool2d(x, window, stride, padding=pads, count_include_pad=True)
