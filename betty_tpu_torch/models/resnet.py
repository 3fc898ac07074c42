"""ResNets: the CIFAR ResNet (ResNet-32 for Meta-Weight-Net), the ImageNet
ResNet with bottleneck blocks (ResNet-50 for ImageNet data pruning) and
the WideResNet.

Counterpart of ``betty_tpu/models/resnet.py`` (``BasicBlock``, ``ResNet``,
``ResNet32``, ``BottleneckBlock``, ``ResNetV1``, ``ResNet50``,
``WideResNet``): inputs are NHWC images as in the JAX package, so one loader
feeds both; the model views them as NCHW (a permute, no copy) for cuDNN.
Convolutions pad as flax's ``"SAME"`` (``models/layers.py::Conv``): a
stride-2 3x3 convolution of an even input pads 0 before and 1 after
(``padding=1`` would shift every output), stride 1 pads 1 on both sides,
the 1x1 projections not at all; ``ResNetV1``'s 7x7 stride-2 stem on 224
pads (2, 3) and its 3x3 stride-2 max pool pads SAME with -inf.
BatchNorm is ``models/batchnorm.py``'s: running statistics come back
through ``updates``, never written in place.

Initialization draws flax's distributions from an explicit
``torch.Generator``: ``lecun_normal`` with fan-in kh*kw*in for the
convolutions and fan-in the pooled width for the head, BatchNorm scale 1
(0 for the last BatchNorm of a bottleneck block, flax's ``scale_init=zeros``)
and bias 0, running mean 0 and variance 1. ``ResNetV1`` and ``WideResNet``
cast their input to the parameters' dtype, as flax promotes a float32 image
against float64 weights. ``betty_tpu_torch.convert.from_flax_resnet`` carries
the JAX package's ``ResNet`` weights over, ``convert.from_flax_net`` those
of the other two.
"""

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.batchnorm import BatchNorm
from betty_tpu_torch.models.init import lecun_normal_
from betty_tpu_torch.models.layers import Conv, max_pool


class BasicBlock(nn.Module):
    def __init__(self, in_features, filters, stride=1, device=None, generator=None):
        super().__init__()
        self.conv0 = Conv(in_features, filters, 3, stride, device, generator)
        self.bn0 = BatchNorm(filters, device=device)
        self.conv1 = Conv(filters, filters, 3, 1, device, generator)
        self.bn1 = BatchNorm(filters, device=device)
        self.proj = self.proj_bn = None
        if stride != 1 or in_features != filters:
            self.proj = Conv(in_features, filters, 1, stride, device, generator)
            self.proj_bn = BatchNorm(filters, device=device)

    def forward(self, x, train=True, updates=None):
        y = F.relu(self.bn0(self.conv0(x), train, updates))
        y = self.bn1(self.conv1(y), train, updates)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), train, updates)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Pre-2015-style CIFAR ResNet: 3 stages of n blocks, widths 16/32/64."""

    def __init__(self, stage_sizes: Sequence[int] = (5, 5, 5), num_classes: int = 10,
                 width: int = 16, in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.conv = Conv(in_channels, width, 3, 1, device, gen)
        self.bn = BatchNorm(width, device=device)
        blocks, features = [], width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(features, filters, stride, device, gen))
                features = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(features, num_classes, device=device)
        lecun_normal_(self.head.weight, fan_in=features, generator=gen)
        nn.init.zeros_(self.head.bias)

    def forward(self, x, train: bool = True, rngs=None, updates=None):
        """``x``: (N, H, W, C) images; returns (N, num_classes) logits."""
        x = F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2)), train, updates))
        for block in self.blocks:
            x = block(x, train, updates)
        return self.head(x.mean(dim=(2, 3)))


def ResNet32(num_classes: int = 10, device=None, seed: int = 0) -> ResNet:
    return ResNet(stage_sizes=(5, 5, 5), num_classes=num_classes, device=device, seed=seed)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``4 * filters``; the residual is projected
    (1x1, strided, BatchNorm) where its shape differs. flax names them
    ``Conv_0..2``/``BatchNorm_0..2`` and the projection ``Conv_3``/
    ``BatchNorm_3``, the order the port registers them in."""

    def __init__(self, in_features, filters, stride=1, device=None, generator=None):
        super().__init__()
        out = 4 * filters
        self.conv0 = Conv(in_features, filters, 1, 1, device, generator)
        self.bn0 = BatchNorm(filters, device=device)
        self.conv1 = Conv(filters, filters, 3, stride, device, generator)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, out, 1, 1, device, generator)
        self.bn2 = BatchNorm(out, device=device, scale_init="zeros")
        self.proj = self.proj_bn = None
        if stride != 1 or in_features != out:
            self.proj = Conv(in_features, out, 1, stride, device, generator)
            self.proj_bn = BatchNorm(out, device=device)

    def forward(self, x, train=True, updates=None):
        y = F.relu(self.bn0(self.conv0(x), train, updates))
        y = F.relu(self.bn1(self.conv1(y), train, updates))
        y = self.bn2(self.conv2(y), train, updates)
        residual = x
        if self.proj is not None:
            residual = self.proj_bn(self.proj(x), train, updates)
        return F.relu(y + residual)


class ResNetV1(nn.Module):
    """ImageNet-style ResNet with bottleneck blocks (ResNet-50/101/152): a
    7x7 stride-2 stem, BatchNorm, ReLU, a 3x3 stride-2 max pool, stages of
    blocks of width ``width * 2 ** stage``, global average pool, head."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 width: int = 64, in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.conv = Conv(in_channels, width, 7, 2, device, gen)
        self.bn = BatchNorm(width, device=device)
        blocks, features = [], width
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BottleneckBlock(features, filters, stride, device, gen))
                features = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(features, num_classes, device=device)
        lecun_normal_(self.head.weight, fan_in=features, generator=gen)
        nn.init.zeros_(self.head.bias)

    def forward(self, x, train: bool = True, rngs=None, updates=None):
        """``x``: (N, H, W, C) images; returns (N, num_classes) logits."""
        x = x.permute(0, 3, 1, 2).to(self.conv.weight.dtype)
        x = F.relu(self.bn(self.conv(x), train, updates))
        x = max_pool(x, 3, 2)
        for block in self.blocks:
            x = block(x, train, updates)
        return self.head(x.mean(dim=(2, 3)))


def ResNet50(num_classes: int = 1000, device=None, seed: int = 0) -> ResNetV1:
    return ResNetV1(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, device=device, seed=seed)


class WideResNet(nn.Module):
    """WRN-depth-widen: a 3x3 stem convolution (no BatchNorm after it), three
    stages of ``(depth - 4) // 6`` basic blocks of widths 16, 32 and 64
    times ``widen``, then BatchNorm, ReLU, global average pool, head."""

    def __init__(self, depth: int = 28, widen: int = 2, num_classes: int = 10,
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        n = (depth - 4) // 6
        widths = [16, 16 * widen, 32 * widen, 64 * widen]
        self.conv = Conv(in_channels, widths[0], 3, 1, device, gen)
        blocks, features = [], widths[0]
        for stage in range(3):
            for block in range(n):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(features, widths[stage + 1], stride, device, gen))
                features = widths[stage + 1]
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm(features, device=device)
        self.head = nn.Linear(features, num_classes, device=device)
        lecun_normal_(self.head.weight, fan_in=features, generator=gen)
        nn.init.zeros_(self.head.bias)

    def forward(self, x, train: bool = True, rngs=None, updates=None):
        """``x``: (N, H, W, C) images; returns (N, num_classes) logits."""
        x = self.conv(x.permute(0, 3, 1, 2).to(self.conv.weight.dtype))
        for block in self.blocks:
            x = block(x, train, updates)
        x = F.relu(self.bn(x, train, updates))
        return self.head(x.mean(dim=(2, 3)))
