"""The port's attention op against betty_tpu's flash attention.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attention.py runs them. The port's ``flash_attention`` on a
CPU tensor goes through ``FlashAttentionFn`` with the kernels' plain
versions (``_fwd_single_plain`` / ``_bwd_single_plain``), so these tests hold
the arithmetic the CUDA kernels repeat. Tolerances are those of
tests/test_flash_attention.py: float32 1e-5 forward, 1e-4 for gradients
relative to max|grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.ops import flash_attention as jfa
from betty_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 96, 16


def _inputs(seed, masked_row=False, pad=False):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = None
    if pad or masked_row:
        mask = np.ones((B, S), bool)
        mask[0, S - 20:] = False
        if masked_row:
            mask[1, :] = False  # every key of batch 1 masked: o = 0, lse = 0
    return q, k, v, w, mask


CASES = [
    dict(causal=False, pad=False, masked_row=False),
    dict(causal=False, pad=True, masked_row=False),
    dict(causal=True, pad=False, masked_row=False),
    dict(causal=True, pad=True, masked_row=False),
    dict(causal=False, pad=False, masked_row=True),
]


def _jax_run(q, k, v, w, mask, causal):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, jm, causal=causal)
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _torch_run(fn, q, k, v, w, mask, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    o = fn(qt, kt, vt, tm, causal=causal)
    grads = torch.autograd.grad((o * torch.tensor(w)).sum(), (qt, kt, vt))
    return o.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(k for k, x in c.items() if x)
                         or "plain")
@pytest.mark.parametrize("fn", ["flash_attention", "reference_attention"])
def test_matches_jax_flash_attention(case, fn):
    q, k, v, w, mask = _inputs(0, pad=case["pad"], masked_row=case["masked_row"])
    jo, jg = _jax_run(q, k, v, w, mask, case["causal"])
    to, tg = _torch_run(getattr(tfa, fn), q, k, v, w, mask, case["causal"])
    assert np.max(np.abs(to - jo)) < 1e-5
    for a, b in zip(tg, jg):
        assert np.max(np.abs(a - b)) <= 1e-4 * max(np.max(np.abs(b)), 1e-6)
    if case["masked_row"]:
        assert np.all(to[1] == 0.0)


def test_lse_matches_jax_single_tile_kernel():
    q, k, v, _, mask = _inputs(1, pad=True, masked_row=True)
    jo, jlse = jfa._fwd_single(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), causal=False,
                               sm_scale=1.0 / np.sqrt(D), interpret=True)
    to, tlse = tfa._fwd_single(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               torch.tensor(mask), causal=False, sm_scale=1.0 / np.sqrt(D))
    assert np.max(np.abs(to.numpy() - np.asarray(jo))) < 1e-5
    assert np.max(np.abs(tlse.numpy() - np.asarray(jlse)[..., 0])) < 1e-5
    assert np.all(tlse.numpy()[1] == 0.0)


def test_bf16_forward_matches_jax():
    q, k, v, _, mask = _inputs(2, pad=True)
    cast = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    jo = jfa.flash_attention(cast(q), cast(k), cast(v), jnp.asarray(mask))
    to = tfa.flash_attention(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                             torch.tensor(mask))
    assert to.dtype == torch.bfloat16
    err = np.max(np.abs(to.float().numpy() - np.asarray(jo.astype(jnp.float32))))
    assert err < 1e-2


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    tfa.reset_launch_counts()
    q, k, v, w, _ = _inputs(3)
    _torch_run(tfa.flash_attention, q, k, v, w, None, False)
    assert tfa._fwd_single.launches == 0 and tfa._bwd_single.launches == 0


def test_long_sequence_on_cuda_path_raises():
    q = torch.empty(1, 1, 640, 64, device="meta")
    with pytest.raises(NotImplementedError, match="B3"):
        tfa._check_kernel_inputs(q, q, q, None)
    with pytest.raises(RuntimeError, match="no kernel"):
        tfa._fwd_single(q, q, q, None, causal=False, sm_scale=0.125)


def test_forward_mode_raises():
    q, k, v, _, _ = _inputs(4)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    with pytest.raises((RuntimeError, NotImplementedError)):
        torch.func.jvp(lambda a: tfa.flash_attention(a, kt, vt), (qt,), (torch.ones_like(qt),))
