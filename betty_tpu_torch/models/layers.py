"""Convolution and pooling with flax's padding, on NCHW tensors.

Shared by ``models/resnet.py`` and ``models/darts.py``. flax's ``"SAME"``
pads ``max((ceil(n / s) - 1) * s + k_eff - n, 0)`` along an axis of size
``n``, the smaller half before, where ``k_eff = (k - 1) * dilation + 1``:
a stride-2 convolution of an even input pads asymmetrically (3x3 on 32:
(0, 1); 5x5: (1, 2); a 3x3 of dilation 2, effective 5: (1, 2); a 5x5 of
dilation 2, effective 9: (3, 4)), which ``F.conv2d``'s symmetric
``padding`` cannot express, so those inputs are padded first.

A grouped convolution (``groups > 1``: the DARTS depthwise convolutions)
runs through ``grouped_conv2d``, whose backward is made of differentiable
convolutions (ROADMAP §C.8): PyTorch's own double backward of a grouped
convolution computes the weight term one group at a time (a convolution,
its slices and copies per channel), and cuDNN runs those at up to 0.4 ms
each; through ``grouped_conv2d`` a second-order pass takes the weight
term as one grouped weight gradient. The values are those of
``F.conv2d``'s derivatives.

``max_pool`` pads SAME with -inf (VALID: no padding, the Omniglot CNN's
pools). ``avg_pool`` pads with zeros and counts them
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


class _GroupedConv2d(torch.autograd.Function):
    """``F.conv2d(x, w, stride, padding, dilation, groups)`` whose backward,
    when its graph is kept (``create_graph``), is differentiable by
    first-order rules: the input gradient is ``conv_transpose2d(gO, w)``
    (differentiated in ``w`` by one grouped weight gradient, where
    ``F.conv2d``'s double backward loops over the groups) and the weight
    gradient is ``convolution_backward``'s. A first-order backward is
    ``F.conv2d``'s own single ``convolution_backward`` call."""

    @staticmethod
    def forward(x, w, stride, padding, dilation, groups):
        return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, padding, dilation, groups = inputs
        ctx.save_for_backward(x, w)
        ctx.save_for_forward(x, w)
        ctx.conf = (stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g_out):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        conf = ([stride] * 2, list(padding), [dilation] * 2, False, [0, 0], groups)
        if not torch.is_grad_enabled():
            # a first-order backward (no create_graph): F.conv2d's own call
            g_x, g_w, _ = torch.ops.aten.convolution_backward(
                g_out, x, w, None, *conf, (*ctx.needs_input_grad[:2], False))
            return g_x, g_w, None, None, None, None
        g_x = g_w = None
        if ctx.needs_input_grad[0]:
            k_eff = [(k - 1) * dilation + 1 for k in w.shape[2:]]
            extra = [n - ((m - 1) * stride - 2 * p + k)
                     for n, m, p, k in zip(x.shape[2:], g_out.shape[2:], padding, k_eff)]
            g_x = F.conv_transpose2d(g_out, w, None, stride, padding, extra, groups, dilation)
        if ctx.needs_input_grad[1]:
            g_w = torch.ops.aten.convolution_backward(g_out, x, w, None, *conf,
                                                      (False, True, False))[1]
        return g_x, g_w, None, None, None, None

    @staticmethod
    def jvp(ctx, x_dot, w_dot, *_):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        out = None
        if x_dot is not None:
            out = F.conv2d(x_dot, w, None, stride, padding, dilation, groups)
        if w_dot is not None:
            term = F.conv2d(x, w_dot, None, stride, padding, dilation, groups)
            out = term if out is None else out + term
        return out


def grouped_conv2d(x, w, stride, padding, dilation, groups):
    """``F.conv2d`` of ``groups`` > 1 through ``_GroupedConv2d`` (the same
    values and derivatives; second-order passes take one grouped weight
    gradient, not one convolution a group)."""
    return _GroupedConv2d.apply(x, w, stride, tuple(padding), dilation, groups)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), kernel_dilation=(d, d),
    feature_group_count=groups, padding=padding, use_bias=use_bias)`` on
    NCHW; the weight is ``(features, in_features // groups, k, k)``, the
    bias (flax's zeros) ``(features,)``."""

    def __init__(self, in_features, features, kernel, stride=1, device=None, generator=None,
                 dilation=1, groups=1, padding="SAME", use_bias=False):
        super().__init__()
        self.stride = stride
        self.dilation = dilation
        self.groups = groups
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel,
                                               device=device))
        lecun_normal_(self.weight, fan_in=in_features // groups * kernel * kernel,
                      generator=generator)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None

    def forward(self, x):
        pads = (0, 0)
        if self.padding == "SAME":
            x, pads = _pad_same(x, self.weight.shape[-1], self.stride, self.dilation)
        if self.groups > 1:
            out = grouped_conv2d(x, self.weight, self.stride, pads, self.dilation, self.groups)
            return out if self.bias is None else out + self.bias[:, None, None]
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=pads,
                        dilation=self.dilation, groups=self.groups)


def max_pool(x, window: int, stride: int, padding: str = "SAME"):
    """flax ``nn.max_pool(x, (w, w), (s, s), padding=padding)`` on NCHW
    (flax's own default is ``"VALID"``: no padding, the windows that fit)."""
    pads = (0, 0)
    if padding == "SAME":
        x, pads = _pad_same(x, window, stride, value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=pads)


def avg_pool(x, window: int, stride: int, padding: str = "SAME"):
    """flax ``nn.avg_pool(x, (w, w), (s, s), padding=padding)`` on NCHW: the
    padded zeros count, every window divides by w * w."""
    pads = (0, 0)
    if padding == "SAME":
        x, pads = _pad_same(x, window, stride)
    return F.avg_pool2d(x, window, stride, padding=pads, count_include_pad=True)
