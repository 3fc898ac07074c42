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
def test_multi_tile_kernels_match_plain_on_card():
    """B3-B5 at S96 with blocks of 32 (two 64-row kernel tiles, the last
    ragged) and a padded mask: the plain forward runs at the kernel's own
    64-row tiles; float32 within 1e-5 forward, 1e-4 x max|ref| backward.
    ``flash_attention`` with those blocks launches B3, B4 and B5 once each
    and neither single-tile kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    q, k, v, w, mask = _inputs(7)
    dev = torch.device("cuda")
    args = [torch.tensor(x, device=dev) for x in (q, k, v)]
    tm = torch.tensor(mask, device=dev)
    kw = dict(causal=False, sm_scale=0.25)
    o, lse = tfa._fwd_multi(*args, tm, block_q=32, block_kv=32, **kw)
    po, plse = tfa._fwd_multi_plain(*args, tm, block_q=64, block_kv=64, **kw)
    torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)
    do = torch.tensor(w, device=dev)
    di = (o * do).sum(-1)
    got = (*tfa._bwd_dkv(*args, do, lse, di, tm, **kw), tfa._bwd_dq(*args, do, lse, di, tm, **kw))
    want = (*tfa._bwd_dkv_plain(*args, do, lse, di, tm, **kw),
            tfa._bwd_dq_plain(*args, do, lse, di, tm, **kw))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)

    tfa.reset_launch_counts()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in args)
    out = tfa.flash_attention(qg, kg, vg, tm, block_q=32, block_kv=32)
    torch.autograd.grad((out * do).sum(), (qg, kg, vg))
    torch.cuda.synchronize()
    assert {n: f.launches for n, f in tfa.KERNELS.items()} == {
        "flash_single_fwd": 0, "flash_single_bwd": 0, "flash_multi_fwd": 1,
        "flash_multi_bwd_dkv": 1, "flash_multi_bwd_dq": 1}


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
