"""The CUDA kernels against their plain versions on the card. Imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Skips without a CUDA device; chip_smoke.py runs the full comparison at the
slices' shapes."""

import math

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

    assert _launches_through_flash_attention(*args, do, tm, False, 32) == MULTI_LAUNCHES


# (B, H, S, D, JAX block, kv mask, causal) of the bf16 multi-tile checks
BF16_BWD_CASES = {
    "S96_D16_blocks32_padded": (2, 2, 96, 16, 32, "padded", False),
    "S384_D64_blocks128_causal": (2, 2, 384, 64, 128, "all_true", True),
    "S256_D128_blocks128_masked_row": (2, 2, 256, 128, 128, "masked_row", False),
}
BF16_FWD_CASES = dict(BF16_BWD_CASES, S320_D32_blocks64_causal=(2, 2, 320, 32, 64, "all_true",
                                                                True))
# (B, H, S, D, kv mask, causal) of the bf16 single-tile checks (default blocks)
BF16_SINGLE_CASES = {
    "S16_D64_all_true": (2, 2, 16, 64, "all_true", False),
    "S96_D16_padded": (2, 2, 96, 16, "padded", False),
    "S200_D128_masked_row": (2, 2, 200, 128, "masked_row", False),
    "S320_D32_causal": (2, 2, 320, 32, "all_true", True),
}


def _bf16_inputs(b, h, s, d, mask_case, seed=11):
    """q, k, v, do in bf16 and the kv mask on the card: "padded" cuts both
    batch elements' keys, "masked_row" masks every key of batch element 1."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(b, h, s, d).astype(np.float32), device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mask = np.ones((b, s), bool)
    if mask_case == "padded":
        mask[0, s - 20:] = False
        mask[1, s // 3:] = False
    elif mask_case == "masked_row":
        mask[0, s // 2:] = False
        mask[1, :] = False
    return q, k, v, do, torch.tensor(mask, device="cuda")


def _launches_through_flash_attention(q, k, v, do, tm, causal, block):
    """Launch counts of one ``flash_attention`` forward and backward, whose
    gradients must be finite."""
    tfa.reset_launch_counts()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = tfa.flash_attention(qg, kg, vg, tm, causal=causal, block_q=block, block_kv=block)
    grads = torch.autograd.grad((out.float() * do.float()).sum(), (qg, kg, vg))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    return {n: f.launches for n, f in tfa.KERNELS.items()}


MULTI_LAUNCHES = {"flash_single_fwd": 0, "flash_single_bwd": 0, "flash_multi_fwd": 1,
                  "flash_multi_bwd_dkv": 1, "flash_multi_bwd_dq": 1}
SINGLE_LAUNCHES = {"flash_single_fwd": 1, "flash_single_bwd": 1, "flash_multi_fwd": 0,
                   "flash_multi_bwd_dkv": 0, "flash_multi_bwd_dq": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BF16_BWD_CASES))
def test_bf16_backward_kernels_match_plain_on_card(case):
    """bf16 B4 and B5 (the tensor-core kernels) against their plain
    versions on the kernels' own lse and di = rowsum(o * do): within 2e-2 x
    max|ref|, as ``TOL`` in chip_smoke.py, because the tensor cores sum in
    another order than the plain einsum, so one bf16 ulp may flip on p, on
    ds and on the outputs. Gradients stay finite where a row is fully
    masked. ``flash_attention`` with the case's blocks launches B3, B4 and
    B5 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    b, h, s, d, block, mask_case, causal = BF16_BWD_CASES[case]
    q, k, v, do, tm = _bf16_inputs(b, h, s, d, mask_case)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_multi(q, k, v, tm, block_q=block, block_kv=block, **kw)
    di = (o.float() * do.float()).sum(-1)
    got = (*tfa._bwd_dkv(q, k, v, do, lse, di, tm, **kw),
           tfa._bwd_dq(q, k, v, do, lse, di, tm, **kw))
    want = (*tfa._bwd_dkv_plain(q, k, v, do, lse, di, tm, **kw),
            tfa._bwd_dq_plain(q, k, v, do, lse, di, tm, **kw))
    for name, a, ref in zip(("dk", "dv", "dq"), got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), name
        err = float((a.float() - ref.float()).abs().max())
        assert err <= 2e-2 * float(ref.float().abs().max()), (name, err)
    assert _launches_through_flash_attention(q, k, v, do, tm, causal, block) == MULTI_LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BF16_FWD_CASES))
def test_bf16_multi_tile_forward_kernel_matches_plain_on_card(case):
    """bf16 B3 (the tensor-core forward) against its plain version at the
    kernel's 64-row tiles, so that p is rounded against the same running
    max: o within 1e-2 x max(1, max|o|) and lse within 1e-2 x max(1,
    max|lse|), as ``TOL`` in chip_smoke.py; a fully masked row gives o = 0
    and lse = 0. ``flash_attention`` with the case's blocks launches B3, B4
    and B5 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    b, h, s, d, block, mask_case, causal = BF16_FWD_CASES[case]
    q, k, v, do, tm = _bf16_inputs(b, h, s, d, mask_case, seed=13)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_multi(q, k, v, tm, block_q=block, block_kv=block, **kw)
    po, plse = tfa._fwd_multi_plain(q, k, v, tm, block_q=64, block_kv=64, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
    assert float((o.float() - po.float()).abs().max()) <= 1e-2 * max(
        1.0, float(po.float().abs().max()))
    assert float((lse - plse).abs().max()) <= 1e-2 * max(1.0, float(plse.abs().max()))
    if mask_case == "masked_row":
        assert bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    assert _launches_through_flash_attention(q, k, v, do, tm, causal, block) == MULTI_LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BF16_SINGLE_CASES))
def test_bf16_single_tile_backward_kernel_matches_plain_on_card(case):
    """bf16 B2 (the tensor-core backward, di computed in the kernel) against
    its plain version on B1's own o and lse: within 2e-2 x max|ref|, as
    ``TOL`` in chip_smoke.py (the tensor cores sum in another order, so one
    bf16 ulp may flip on p, ds and the outputs); finite where a row is fully
    masked. ``flash_attention`` with the default blocks launches B1 and B2
    once each and no multi-tile kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    b, h, s, d, mask_case, causal = BF16_SINGLE_CASES[case]
    q, k, v, do, tm = _bf16_inputs(b, h, s, d, mask_case, seed=17)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_single(q, k, v, tm, **kw)
    got = tfa._bwd_single(q, k, v, do, o, lse, tm, **kw)
    want = tfa._bwd_single_plain(q, k, v, do, o, lse, tm, **kw)
    for name, a, ref in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), name
        err = float((a.float() - ref.float()).abs().max())
        assert err <= 2e-2 * float(ref.float().abs().max()), (name, err)
    assert _launches_through_flash_attention(q, k, v, do, tm, causal, None) == SINGLE_LAUNCHES


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
