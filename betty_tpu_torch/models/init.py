"""Initializers with flax's default distributions, drawn from an explicit
``torch.Generator`` (the port's weights are random, made from a seed; they
do not reproduce the JAX package's bits, which ``betty_tpu_torch.convert``
carries over where a test needs them)."""

import math

import torch

# std of a standard normal truncated to [-2, 2]: flax's truncated-normal
# variance-scaling initializers divide by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator = None):
    """flax ``lecun_normal``: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator = None):
    return t.normal_(0.0, std, generator=generator)
