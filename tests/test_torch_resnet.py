"""The port's ResNet and BatchNorm against flax (``betty_tpu/models/resnet.py``)
on the same weights (moved with ``convert.from_flax_resnet``) and inputs, in
float32 on the CPU: ResNet-32 logits in train and eval mode within 1e-5 of
max|logits|; BatchNorm's output (relative to the largest) and new running
statistics within 1e-6 of flax's on the same input (train mode: biased
batch variance, 0.9 old + 0.1 batch); flax's SAME padding on stride-2
convolutions; no tensor written in place; and a forward-over-reverse HVP
through a train-mode forward."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from betty_tpu.models import ResNet32 as JResNet32
from betty_tpu_torch import convert
from betty_tpu_torch.hypergradient.hvp import make_hvp
from betty_tpu_torch.models import ResNet, ResNet32
from betty_tpu_torch.models.batchnorm import BatchNorm
from betty_tpu_torch.models.resnet import Conv
from betty_tpu_torch.module import from_torch


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n, seed=0, hw=32):
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)


@pytest.fixture(scope="module")
def resnet32():
    """flax ResNet-32 variables (batch_stats moved off 0/1 by one train
    step, so that eval mode reads real statistics) and the port's module."""
    jm = JResNet32(10)
    x = jnp.asarray(_images(4, seed=1))
    v = jm.init(jax.random.PRNGKey(0), x, train=False)
    _, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
    v = _numpy({"params": v["params"], "batch_stats": mut["batch_stats"]})
    return jm, v, from_torch(ResNet32())


def test_resnet32_shapes_and_names_match_flax(resnet32):
    _, v, fm = resnet32
    params, stats = convert.from_flax_resnet(v)
    assert {k: tuple(t.shape) for k, t in params.items()} == {
        k: tuple(t.shape) for k, t in fm.variables["params"].items()}
    assert {k: tuple(t.shape) for k, t in stats.items()} == {
        k: tuple(t.shape) for k, t in fm.variables["batch_stats"].items()}
    assert sum(t.numel() for t in params.values()) == 466_906
    assert fm.mutable_collections == ("batch_stats",)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet32_logits_match_flax(resnet32, train):
    jm, v, fm = resnet32
    x = _images(8)
    params, stats = convert.from_flax_resnet(v)
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    got = fm.apply({"params": params, "batch_stats": stats}, torch.tensor(x), train=train)
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_resnet32_batch_stats_match_flax(resnet32):
    """One train-mode forward: every new running statistic within 1e-5 and
    the stem's (same input on both sides) within 1e-6; deeper layers see
    inputs that already differ in the last bits."""
    jm, v, fm = resnet32
    x = _images(8)
    params, stats = convert.from_flax_resnet(v)
    _, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _, want = convert.from_flax_resnet({"params": v["params"],
                                        "batch_stats": _numpy(mut["batch_stats"])})
    _, got = fm.apply({"params": params, "batch_stats": stats}, torch.tensor(x), train=True,
                      mutable=("batch_stats",))
    got = got["batch_stats"]
    assert set(got) == set(want)
    errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])
    assert max(errs["bn.running_mean"], errs["bn.running_var"]) <= 1e-6, errs
    assert any(float((got[k] - stats[k]).abs().max()) > 1e-3 for k in got)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_flax(train):
    """Output and new statistics of one BatchNorm on the same input: 4 x 3 x
    3 positions a channel, so an unbiased variance (n/(n-1) = 1.03) or
    another momentum shows."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 3, 3, 8) * 2 + 0.5).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": rng.rand(8).astype(np.float32) + 0.5,
                    "bias": rng.randn(8).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(8).astype(np.float32),
                         "var": rng.rand(8).astype(np.float32) + 0.5}}
    want, mut = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(8)
    tensors = {"weight": v["params"]["scale"], "bias": v["params"]["bias"],
               "running_mean": v["batch_stats"]["mean"], "running_var": v["batch_stats"]["var"]}
    updates = {}
    got = torch.func.functional_call(
        bn, {k: torch.tensor(t) for k, t in tensors.items()},
        (torch.tensor(x).permute(0, 3, 1, 2),), {"train": train, "updates": updates})
    want = np.asarray(want)
    err = np.abs(got.permute(0, 2, 3, 1).detach().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-6, err
    if not train:  # eval mode reports no statistics, as flax leaves them
        assert not updates
        return
    assert set(updates) == {(bn, "running_mean"), (bn, "running_var")}
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        e = np.abs(updates[(bn, ours)].numpy() - np.asarray(mut["batch_stats"][theirs])).max()
        assert e <= 1e-6, (ours, e)


@pytest.mark.parametrize("hw", [8, 7])
def test_stride2_conv_pads_as_flax_same(hw):
    """A stride-2 3x3 convolution pads as flax's "SAME": (0, 1) on an even
    input, (1, 1) on an odd one. Symmetric padding 1 differs on the even
    input."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, hw, hw, 4).astype(np.float32)
    jconv = nn.Conv(6, (3, 3), (2, 2), use_bias=False)
    v = _numpy(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jconv.apply(v, jnp.asarray(x)))
    conv = Conv(4, 6, 3, stride=2)
    w = torch.tensor(np.transpose(v["params"]["kernel"], (3, 2, 0, 1)))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(conv, {"weight": w}, (xt,)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    symmetric = F.conv2d(xt, w, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    if hw % 2 == 0:
        assert np.abs(symmetric - want).max() > 1e-2
    else:
        assert np.abs(symmetric - want).max() <= 1e-5


def test_train_forward_writes_no_tensor_in_place():
    """A train-mode forward that returns new statistics leaves params,
    batch_stats and the input as they were (values and version counters)."""
    fm = from_torch(ResNet((1, 1, 1)))
    variables = {"params": {k: t.clone().requires_grad_(True)
                            for k, t in fm.variables["params"].items()},
                 "batch_stats": {k: t.clone() for k, t in fm.variables["batch_stats"].items()}}
    x = torch.tensor(_images(4))
    tensors = [x, *variables["params"].values(), *variables["batch_stats"].values()]
    before = [(t.detach().clone(), t._version) for t in tensors]
    for mutable in (("batch_stats",), ()):
        out = fm.apply(variables, x, train=True, mutable=mutable)
        loss = (out[0] if mutable else out).square().mean()
        loss.backward()
    for t, (value, version) in zip(tensors, before):
        assert torch.equal(t, value) and t._version == version
    _, new = fm.apply(variables, x, train=True, mutable=("batch_stats",))
    assert all(new["batch_stats"][k] is not t for k, t in variables["batch_stats"].items())


def test_jvp_over_grad_hvp_through_train_mode_forward():
    """``make_hvp(mode="jvp")`` (torch.func.jvp of torch.func.grad) through a
    train-mode BatchNorm ResNet gives the reverse-over-reverse product, and
    the statistics stay untouched."""
    torch.manual_seed(0)
    fm = from_torch(ResNet((1, 1, 1)))
    stats = {k: t.clone() for k, t in fm.variables["batch_stats"].items()}
    x = torch.tensor(_images(4))
    y = torch.tensor([1, 3, 5, 7])
    mwn = {"s": torch.tensor(0.7)}

    def loss(w, prev):
        out = fm.apply({"params": w, "batch_stats": stats}, x, train=True)
        return prev["s"] * F.cross_entropy(out, y)

    w0 = {k: t.clone() for k, t in fm.variables["params"].items()}
    gen = torch.Generator().manual_seed(1)
    p = {k: torch.randn(t.shape, generator=gen) for k, t in w0.items()}
    fwd = make_hvp(loss, w0, mwn, mode="jvp")(p)
    rev = make_hvp(loss, w0, mwn, mode="vjp")(p)
    scale = max(float(t.abs().max()) for t in rev.values())
    err = max(float((fwd[k] - rev[k]).abs().max()) for k in rev)
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)
    assert all(torch.equal(stats[k], fm.variables["batch_stats"][k]) for k in stats)
