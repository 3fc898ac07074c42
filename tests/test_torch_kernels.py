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


def _card_inputs(b, h, s, d, mask_case, seed=11, dtype=torch.bfloat16):
    """q, k, v, do in ``dtype`` and the kv mask on the card: "padded" cuts
    both batch elements' keys, "masked_row" masks every key of batch
    element 1."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.tensor(rng.randn(b, h, s, d).astype(np.float32), device="cuda")
                   .to(dtype) for _ in range(4))
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
    q, k, v, do, tm = _card_inputs(b, h, s, d, mask_case)
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
    q, k, v, do, tm = _card_inputs(b, h, s, d, mask_case, seed=13)
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
    q, k, v, do, tm = _card_inputs(b, h, s, d, mask_case, seed=17)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_single(q, k, v, tm, **kw)
    got = tfa._bwd_single(q, k, v, do, o, lse, tm, **kw)
    want = tfa._bwd_single_plain(q, k, v, do, o, lse, tm, **kw)
    for name, a, ref in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()), name
        err = float((a.float() - ref.float()).abs().max())
        assert err <= 2e-2 * float(ref.float().abs().max()), (name, err)
    assert _launches_through_flash_attention(q, k, v, do, tm, causal, None) == SINGLE_LAUNCHES


MASK_CASES = ("all_true", "padded", "causal", "masked_row")
# float32 B3-B5 checks: every head dim at S200 (ragged: 3 x 64 + 8 and
# 6 x 32 + 8 rows), each mask case; and Sq != Skv: (d, mask case, Sq, Skv)
FP32_MULTI_CASES = dict({f"D{d}_{m}": (d, m, 200, 200) for d in tfa.KERNEL_HEAD_DIMS
                         for m in MASK_CASES},
                        Sq136_Skv264_D64_padded=(64, "padded", 136, 264),
                        Sq264_Skv136_D32_causal=(32, "causal", 264, 136))


def _card_qkv(b, h, sq, skv, d, mask_case, seed, dtype):
    """q, do of Sq rows, k, v of Skv rows and the (b, Skv) kv mask on the
    card, as ``_card_inputs``."""
    q, _, _, do, _ = _card_inputs(b, h, sq, d, "all_true", seed=seed, dtype=dtype)
    _, k, v, _, tm = _card_inputs(b, h, skv, d, mask_case, seed=seed + 1, dtype=dtype)
    return q, k, v, do, tm


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FP32_MULTI_CASES))
def test_fp32_backward_kernels_match_plain_on_card(case):
    """float32 B3 (flash_fp32.cuh's forward) against its plain version at
    the kernel's 64-row tiles: o within 1e-5 x max(1, max|o|), lse within
    1e-5 x max(1, max|lse|), a fully masked row's o and lse 0. Then float32
    B4 and B5 (exact float32 FMAs on the CUDA cores) against their plain
    versions on B3's own lse and di = rowsum(o * do): within 1e-5 x
    max|ref|, since only the order of float32 sums can differ. At S200 the
    last 64-row and 32-row tiles are ragged. Gradients stay finite and a
    fully masked row's are 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    d, mask_case, sq, skv = FP32_MULTI_CASES[case]
    q, k, v, do, tm = _card_qkv(2, 2, sq, skv, d,
                                "all_true" if mask_case == "causal" else mask_case, 19,
                                torch.float32)
    kw = dict(causal=mask_case == "causal", sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_multi(q, k, v, tm, block_q=64, block_kv=64, **kw)
    po, plse = tfa._fwd_multi_plain(q, k, v, tm, block_q=64, block_kv=64, **kw)
    torch.cuda.synchronize()
    assert float((o - po).abs().max()) <= 1e-5 * max(1.0, float(po.abs().max()))
    assert float((lse - plse).abs().max()) <= 1e-5 * max(1.0, float(plse.abs().max()))
    if mask_case == "masked_row":
        assert bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    di = (o * do).sum(-1)
    got = (*tfa._bwd_dkv(q, k, v, do, lse, di, tm, **kw),
           tfa._bwd_dq(q, k, v, do, lse, di, tm, **kw))
    want = (*tfa._bwd_dkv_plain(q, k, v, do, lse, di, tm, **kw),
            tfa._bwd_dq_plain(q, k, v, do, lse, di, tm, **kw))
    torch.cuda.synchronize()
    for name, a, ref in zip(("dk", "dv", "dq"), got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all()), name
        err = float((a - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
        if mask_case == "masked_row":
            assert bool((a[1] == 0).all()), name


# float32 B1/B2 checks (default blocks, single tile): every head dim x mask
# case at S96 (B1 in one chunk of 128 keys) and S200 (two chunks; a ragged
# last 64-row tile), and Sq != Skv either way: (d, mask case, Sq, Skv)
FP32_SINGLE_CASES = dict({f"S{s}_D{d}_{m}": (d, m, s, s) for s in (96, 200)
                          for d in tfa.KERNEL_HEAD_DIMS for m in MASK_CASES},
                         Sq96_Skv160_D32_masked_row=(32, "masked_row", 96, 160),
                         Sq200_Skv72_D64_causal=(64, "causal", 200, 72))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FP32_SINGLE_CASES))
def test_fp32_single_tile_kernels_match_plain_on_card(case):
    """float32 B1 (on B3's body) against ``_fwd_single_plain``: o within
    1e-5 x max(1, max|o|), lse within 1e-5 x max(1, max|lse|). float32 B2
    (B4's body, then B5's, di summed in the kernel) against
    ``_bwd_single_plain`` on B1's own o and lse: within 1e-5 x max|ref|,
    since only the order of float32 sums differs. A fully masked row's o,
    lse and gradients are 0; gradients are finite; ``flash_attention`` with
    the default blocks launches B1 and B2 once each and no multi-tile
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    d, mask_case, sq, skv = FP32_SINGLE_CASES[case]
    q, k, v, do, tm = _card_qkv(2, 2, sq, skv, d,
                                "all_true" if mask_case == "causal" else mask_case, 29,
                                torch.float32)
    kw = dict(causal=mask_case == "causal", sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_single(q, k, v, tm, **kw)
    po, plse = tfa._fwd_single_plain(q, k, v, tm, **kw)
    torch.cuda.synchronize()
    assert float((o - po).abs().max()) <= 1e-5 * max(1.0, float(po.abs().max()))
    assert float((lse - plse).abs().max()) <= 1e-5 * max(1.0, float(plse.abs().max()))
    if mask_case == "masked_row":
        assert bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    got = tfa._bwd_single(q, k, v, do, o, lse, tm, **kw)
    want = tfa._bwd_single_plain(q, k, v, do, o, lse, tm, **kw)
    torch.cuda.synchronize()
    for name, a, ref in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all()), name
        err = float((a - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)
        if mask_case == "masked_row":
            assert bool((a[1] == 0).all()), name
    assert _launches_through_flash_attention(q, k, v, do, tm, kw["causal"],
                                             None) == SINGLE_LAUNCHES


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x``: 2^(e-8) for |x| = m 2^e,
    0.5 <= m < 1."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# the bf16 B1 one-ulp checks: every head dim x mask case at S200, the
# single-tile edges, the S128 path's width, and Sq != Skv:
# (b, h, Sq, Skv, d, kv mask, causal)
B1_ULP_CASES = dict(
    {f"S200_D{d}_{m}": (2, 2, 200, 200, d, "all_true" if m == "causal" else m, m == "causal")
     for d in tfa.KERNEL_HEAD_DIMS for m in MASK_CASES},
    **{name: (b, h, s, s, d, m, c) for name, (b, h, s, d, m, c) in BF16_SINGLE_CASES.items()},
    S128_D64_padded=(2, 2, 128, 128, 64, "padded", False),
    Sq96_Skv320_D64_padded=(2, 2, 96, 320, 64, "padded", False),
    Sq320_Skv96_D128_causal=(2, 2, 320, 96, 128, "all_true", True))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(B1_ULP_CASES))
def test_bf16_single_tile_forward_within_one_ulp_on_card(case):
    """bf16 B1 (the tensor-core forward) rounds p to bf16 against the row
    max, as betty_tpu's ``_fwd_single_kernel`` and the plain version do:
    its o is within one bf16 ulp of the plain o, element by element (the
    kernel takes the row max, p near a bf16 rounding midpoint and o that
    nearly cancels from the plain version's float32 chains), and lse within
    1e-5 x max(1, max|lse|); a fully masked row gives o = 0 and lse = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    b, h, sq, skv, d, mask_case, causal = B1_ULP_CASES[case]
    q, k, v, _, tm = _card_qkv(b, h, sq, skv, d, mask_case, 23, torch.bfloat16)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(d))
    o, lse = tfa._fwd_single(q, k, v, tm, **kw)
    po, plse = tfa._fwd_single_plain(q, k, v, tm, **kw)
    torch.cuda.synchronize()
    diff = (o.float() - po.float()).abs()
    assert bool((diff <= _bf16_ulp(po)).all()), float((diff / _bf16_ulp(po)).max())
    assert float((lse - plse).abs().max()) <= 1e-5 * max(1.0, float(plse.abs().max()))
    if mask_case == "masked_row":
        assert bool((o[1] == 0).all()) and bool((lse[1] == 0).all())


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
