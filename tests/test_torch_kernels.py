"""The CUDA kernels against their plain versions on the card. Imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Skips without a CUDA device; chip_smoke.py runs the full comparison at the
slices' shapes."""

import numpy as np
import pytest
import torch

from betty_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 96, 16


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), bool)
    mask[0, S - 20:] = False
    return q, k, v, w, mask


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    q, k, v, w, mask = _inputs(5)
    dev = torch.device("cuda")
    args = [torch.tensor(x, device=dev) for x in (q, k, v)]
    tm = torch.tensor(mask, device=dev)
    o, lse = tfa._fwd_single(*args, tm, causal=False, sm_scale=0.25)
    po, plse = tfa._fwd_single_plain(*args, tm, causal=False, sm_scale=0.25)
    torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)
    do = torch.tensor(w, device=dev)
    got = tfa._bwd_single(*args, do, o, lse, tm, causal=False, sm_scale=0.25)
    want = tfa._bwd_single_plain(*args, do, po, plse, tm, causal=False, sm_scale=0.25)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


@pytest.mark.gpu
def test_vector_kernels_match_plain_on_card():
    """B6-B8 on a ragged length (3 * TILE + 1000): elementwise outputs
    within 1e-6 x max|ref| (fused multiply-add against a separate multiply
    and add), dots within 1e-5 x sum|a_i b_i| (another summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    from betty_tpu_torch.ops import vector as tv

    rng = np.random.RandomState(6)
    n = 3 * tv.TILE + 1000
    a, b, c, d = (torch.tensor(rng.randn(n).astype(np.float32), device="cuda")
                  for _ in range(4))
    ak = torch.tensor(0.37, device="cuda")

    def close(got, want):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())

    def close_dot(got, want, x, y):
        assert abs(float(got) - float(want)) <= 1e-5 * float((x * y).abs().sum())

    for got, want, pair in zip(tv.fused_dot2(a, b, c, d), tv.fused_dot2_plain(a, b, c, d),
                               ((a, b), (c, d))):
        close_dot(got, want, *pair)
    x2, r2, rr = tv.cg_fused_step(ak, a, b, c, d)
    px, pr, prr = tv.cg_fused_step_plain(ak, a, b, c, d)
    close(x2, px)
    close(r2, pr)
    close_dot(rr, prr, pr, pr)
    for got, want in zip(tv.neumann_fused_step(0.5, a, b, c),
                         tv.neumann_fused_step_plain(0.5, a, b, c)):
        close(got, want)
    torch.cuda.synchronize()
