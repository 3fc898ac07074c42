"""The port's ``models/mlp.py::MLP`` and ``convert.from_flax_mlp`` against
flax's ``betty_tpu/models/mlp.py::MLP`` in float32: the JAX package's
initialized parameters carried over, outputs and gradients (to the
parameters and the input, for a random output cotangent) within 1e-6 of
max(1, |flax|), for every
activation name the port takes; the port's own initialization draws
flax's distribution (lecun-normal kernels, zero biases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.models.mlp import MLP as FlaxMLP
from betty_tpu_torch import convert
from betty_tpu_torch.models import MLP
from betty_tpu_torch.models.mlp import ACTIVATIONS

TOL = 1e-6


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_mlp_matches_flax(activation):
    features = [24, 16, 5]
    rs = np.random.RandomState(0)
    x = rs.randn(7, 12).astype(np.float32) * 2.0
    cot = rs.randn(7, features[-1]).astype(np.float32)  # the output's cotangent
    fmod = FlaxMLP(features=features, activation=activation)
    params = fmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def floss(p, xin):
        out = fmod.apply({"params": p}, xin)
        return jnp.sum(out * cot), out

    (_, fout), (fgrad_p, fgrad_x) = jax.value_and_grad(floss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    net = MLP(12, features, activation=activation)
    tparams = convert.from_flax_mlp(jax.tree_util.tree_map(np.asarray, params))
    assert set(tparams) == {k for k, _ in net.named_parameters()}
    tparams = {k: v.requires_grad_(True) for k, v in tparams.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout = torch.func.functional_call(net, tparams, (tx,))
    grads = torch.autograd.grad(torch.sum(tout * torch.tensor(cot)), [tx, *tparams.values()])
    assert _rel(tout.detach(), fout) <= TOL
    assert _rel(grads[0], fgrad_x) <= TOL
    want = convert.from_flax_mlp(jax.tree_util.tree_map(np.asarray, fgrad_p))
    for (name, _), g in zip(tparams.items(), grads[1:]):
        assert _rel(g, want[name].numpy()) <= TOL, name


def test_mlp_initialization_draws_flax_distribution():
    net = MLP(400, [300, 3], generator=torch.Generator().manual_seed(0))
    w = net.layers[0].weight.detach()
    assert w.shape == (300, 400)
    assert all(float(layer.bias.detach().abs().max()) == 0.0 for layer in net.layers)
    # lecun normal: truncated at two standard deviations, variance 1 / fan_in
    assert abs(float(w.std()) - (1 / 400) ** 0.5) < 0.02 * (1 / 400) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978 + 1e-6
    again = MLP(400, [300, 3], generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


def test_mlp_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        MLP(4, [2], activation="swishy")
