"""The ImageNet ResNet (``BottleneckBlock``, ``ResNetV1``, ``ResNet50``) and
the ``WideResNet`` of the port's ``models/resnet.py`` against flax's
(``betty_tpu/models/resnet.py``), with the port's weights carried over
(``torch_darts_common.to_flax``, the inverse of
``convert.from_flax_net``).

* Logits and new running statistics in train mode and logits in eval mode,
  in float32 within 1e-5 and float64 within 1e-10 (relative to max(1,
  max|flax|)): a bottleneck block with and without its projection,
  ``ResNetV1`` at stages ``[1, 1]`` and ``[1, 1, 1, 1]`` (the stem's 7x7
  stride-2 convolution and SAME max pool), width 8, and
  ``WideResNet(10, 2)``; float64 with every BatchNorm scale random (the
  zero-scale last norm of a block would hide its branch), float32 at the
  networks' own initial scales.
* In float64 also the gradients of the parameters and of the input (train
  mode; a block, ``ResNetV1`` at ``[1, 1]``, ``WideResNet(10, 2)``).
* Each bottleneck's last BatchNorm starts at scale 0 as flax's, the others
  at 1; ``ResNet50`` has 25,557,032 parameters in 161 leaves.
* A bfloat16 input has its statistics taken in float32 (flax's
  ``force_float32_reductions``): float32 running statistics equal to
  flax's.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.models import resnet as J
from betty_tpu_torch import convert
from betty_tpu_torch.models import resnet as T
from betty_tpu_torch.models.batchnorm import BatchNorm
from torch_darts_common import (assert_within, compare, module_state, one_thread, port_apply,
                                to_flax, with_stats)

one_thread = pytest.fixture(autouse=True)(one_thread)


def _scaled(net, seed=2):
    """``net`` with running statistics away from 0 and 1 and every
    BatchNorm scale random, so that a zero-scale norm does not hide its
    branch."""
    with_stats(net, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
    return net


NETS = {
    "block_proj": (lambda: J.BottleneckBlock(4, 2), lambda: T.BottleneckBlock(8, 4, 2), 8, True),
    "block_identity": (lambda: J.BottleneckBlock(4, 1), lambda: T.BottleneckBlock(16, 4, 1), 16,
                       True),
    "v1_2": (lambda: J.ResNetV1(stage_sizes=(1, 1), num_classes=10, width=8),
             lambda: T.ResNetV1(stage_sizes=(1, 1), num_classes=10, width=8), 3, False),
    "v1_4": (lambda: J.ResNetV1(stage_sizes=(1, 1, 1, 1), num_classes=10, width=8),
             lambda: T.ResNetV1(stage_sizes=(1, 1, 1, 1), num_classes=10, width=8), 3, False),
    "wrn": (lambda: J.WideResNet(depth=10, widen=2), lambda: T.WideResNet(10, 2), 3, False),
}


def _forward_errs(jmod, tnet, x, dtype, train):
    """Logits (and, in train mode, new running statistics) of flax's and the
    port's module on ``x`` (NHWC), relative to max(1, max|flax|)."""
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        params, stats = module_state(tnet, dtype)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), to_flax(tnet, params, stats))
        xj = jnp.asarray(x, jd)
        if train:
            jout, mut = jmod.apply(v, xj, train=True, mutable=["batch_stats"])
        else:
            jout, mut = jmod.apply(v, xj, train=False), {}
        jout = np.asarray(jout)
        want = convert.from_flax_net({"params": v["params"], **jax.tree_util.tree_map(
            np.asarray, mut)}, tnet, dtype=torch.float64)[1] if train else {}
    xt = torch.tensor(x, dtype=dtype)
    nchw = xt.permute(0, 3, 1, 2) if isinstance(tnet, T.BottleneckBlock) else xt
    out, new = port_apply(tnet, params, stats, nchw, train=train)
    if out.dim() == 4:
        out = out.permute(0, 2, 3, 1)
    scale = max(1.0, float(np.abs(jout).max()))
    errs = {"out": float(np.abs(out.detach().numpy() - jout).max()) / scale}
    assert set(new) == set(want)
    for k, w in want.items():
        scale = max(1.0, float(w.abs().max()))
        errs[f"stat {k}"] = float((new[k].double() - w).abs().max()) / scale
    return errs


# input side of each network: the last stage of [1, 1, 1, 1] keeps 2x2
# pixels (a BatchNorm over one pixel of a small batch normalizes its inputs
# to about +-1 whatever they are, and its rounding dominates the output)
SIZES = {"block_proj": 8, "block_identity": 8, "v1_2": 32, "v1_4": 64, "wrn": 16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(NETS))
def test_forward_matches_flax(name, train, dtype):
    jmod, tmod, channels, _ = NETS[name]
    x = np.random.RandomState(0).randn(4, SIZES[name], SIZES[name], channels)
    # float32 keeps the networks' own scales: under random ones flax's
    # float32 statistics (E[x^2] - E[x]^2) drift 1.5e-5 from the float64
    # logits of [1, 1, 1, 1] and the port's 3e-6
    net = _scaled(tmod()) if dtype == torch.float64 else with_stats(tmod())
    errs = _forward_errs(jmod(), net, x.astype(np.float32), dtype, train)
    assert_within(errs, dtype)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["block_proj", "v1_2", "wrn"])
def test_float64_matches_flax_with_gradients(name, train):
    jmod, tmod, channels, nchw = NETS[name]
    x = np.random.RandomState(1).randn(2, SIZES[name], SIZES[name], channels)
    errs = compare(jmod(), _scaled(tmod()), [x], torch.float64, train=train, nchw=nchw)
    if train:
        assert any(k.startswith("grad") for k in errs) and any(k.startswith("stat") for k in errs)
    assert_within(errs, torch.float64)


def test_zero_scale_init_and_resnet50_size():
    variables = J.ResNetV1(stage_sizes=(1, 2), num_classes=10, width=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    net = T.ResNetV1(stage_sizes=(1, 2), num_classes=10, width=8)
    params, _ = module_state(net, torch.float32)
    want, _ = convert.from_flax_net(jax.tree_util.tree_map(np.asarray, variables), net)
    assert set(want) == set(params)
    norms = [k for k in want if "bn" in k.split(".")[-2] and k.endswith(".weight")]
    assert len(norms) == 1 + 3 * 3 + 2  # the stem's, 3 a block and 2 projections
    for k in norms:  # flax's scale, 0 or 1
        np.testing.assert_array_equal(params[k].numpy(), want[k].numpy())
    assert all(not params[f"blocks.{i}.bn2.weight"].any() for i in range(3))
    assert all(params[f"blocks.{i}.bn0.weight"].eq(1).all() for i in range(3))
    r50 = T.ResNet50()
    assert sum(p.numel() for p in r50.parameters()) == 25_557_032
    assert len(list(r50.parameters())) == 161
    assert sum(isinstance(m, BatchNorm) for m in r50.modules()) == 53


def test_bf16_statistics_in_float32():
    x = np.random.RandomState(3).randn(4, 6, 6, 5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    norm = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = norm.init(jax.random.PRNGKey(0), xb)
    jout, mut = norm.apply(v, xb, mutable=["batch_stats"])
    bn = BatchNorm(5)
    updates = {}
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2)
    out = bn(xt, train=True, updates=updates)
    assert out.dtype == torch.bfloat16
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        got = updates[(bn, name)]
        want = np.asarray(mut["batch_stats"][key])
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout.astype(jnp.float32)), atol=2e-2)
