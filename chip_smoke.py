"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py                          # every phase (needs one card)
    python3 chip_smoke.py --phases kernels         # build and check the kernels only
    python3 chip_smoke.py --phases kernels,long    # ... and the S1024 runs

Phases:

1. set-up: print the card's name and power limit, turn TF32 off, build the
   CUDA sources of ``betty_tpu_torch/csrc`` (one ``nvcc`` each, all started
   together, each timed);
2. kernels (always): hold each single-tile flash-attention kernel (B1, B2)
   against its plain PyTorch version on the card at the SAMA path's shape
   (B32 H16 S128 D64) in bfloat16 and float32, with an all-true mask, a
   padded mask, a fully masked row and causal masking, and at four edge
   shapes (S16 D64, the small runs' ragged tile; S96 D16 padded; S200 D128
   with a fully masked row; S320 D32 causal), where ``flash_attention``
   with the default blocks must launch B1 and B2 and no multi-tile kernel;
   bf16 B1 is held elementwise to one bf16 ulp of its plain version (p
   rounded against the row max on both sides); time them (with their
   achieved TFLOP/s) beside their plain versions and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it), each as the mean of 20 launches queued back to back behind a
   sleeping kernel between one pair of events, so that the host's enqueue
   rate is not timed; the same for the multi-tile
   kernels (B3, B4, B5) at the long-sequence path's shape (B8 H16 S1024
   D64) and at four edge shapes (S384 with blocks of 128 and causal
   masking; S96 with blocks of 32 and D16, a ragged last tile; S256 D128
   with blocks of 128 and a fully masked row; S320 D32 with blocks of 64
   and causal masking), where ``flash_attention`` with those blocks must
   launch B3-B5 and not B1/B2 (float32 B3 within 1e-5 on o and lse, B4
   and B5 within 1e-5 x max|ref|);
   the multi-tile timings with their achieved TFLOP/s; each kernel's
   registers and spills as ``ptxas`` reports them (the bf16 tensor-core
   kernels, B1-B5, and the float32 B3, B4 and B5 may not spill at D64),
   the count of tensor-core (``HMMA``) instructions in each tensor-core
   kernel at every head dim from ``cuobjdump --dump-sass`` (it must not be
   0), and the ``FFMA``, ``LDS`` and ``LDS.128`` counts of the float32 B3,
   B4 and B5 and of each of their product loops (at D64 at least 8
   ``FFMA`` per shared-memory load in every product loop, and no
   ``HMMA``);
   then the solvers' vector kernels (B6, B7, B8) at the CG/Neumann path's
   length (the RoBERTa-large classifier's parameter count, padded to the
   ravel tile) and at a ragged length, timed beside their plain versions
   (no single PyTorch call computes any of the three);
3. slice: small fp32 reweighting runs (SAMA with ``--flash``, then CG and
   Neumann on the plain attention with the fused vector loops) on the card
   against the same runs on the CPU (plain versions) from the same weights;
   then data reweighting of the RoBERTa-large encoder (24 layers, d 1024, 16
   heads, random weights from a seed) at B32 S128 through ``build_engine``
   and ``Engine.run``: two SAMA meta-periods with ``--flash`` and one more
   under ``torch.profiler``; two CG meta-periods (3 iterations, fused
   vector loops, dropout 0.1) and one more under the profiler; two Neumann
   meta-periods (3 iterations);
4. long: the small fp32 SAMA ``--flash`` run at S1024 on the card against
   the CPU (the multi-tile path); then SAMA reweighting of the RoBERTa-large
   encoder at B8 S1024 with ``--flash``: two meta-periods and one more
   under the profiler (flash device time split by input dtype).

Each run reads the launch counts of its kernels, set to 0 just before it,
and holds them to the counts its code path implies.

Prints one JSON line of kernel results, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when there is no CUDA card, when the port cannot be imported, or
when any phase fails.
"""

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its operand type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SHAPE = dict(B=32, H=16, S=128, D=64)  # the single-tile path (S128 SAMA run)
LONG_SHAPE = dict(B=8, H=16, S=1024, D=64)  # the multi-tile path (S1024 SAMA run)
# multi-tile edge shapes: (B, H, S, D, block, mask case)
EDGE_SHAPES = [(2, 4, 384, 64, 128, "causal"), (2, 4, 96, 16, 32, "padded"),
               (2, 4, 256, 128, 128, "masked_row"), (2, 4, 320, 32, 64, "causal")]
# single-tile edge shapes (default blocks): (B, H, S, D, mask case)
SINGLE_EDGE_SHAPES = [(2, 4, 16, 64, "all_true"), (2, 4, 96, 16, "padded"),
                      (2, 4, 200, 128, "masked_row"), (2, 4, 320, 32, "causal")]
KERNEL_TILE = 64  # rows per tile of the CUDA flash kernels


def roberta_large_params(vocab=50265, max_len=128, d=1024, depth=24, classes=2):
    """Parameter count of the port's RoBERTa-large classifier by its shapes:
    embeddings (``max_len`` position rows: the example sets it to the
    sequence length), 24 blocks of 12 d^2 + 13 d (q/k/v/out projections with
    biases, two LayerNorms, the 4d MLP), the final LayerNorm, pooler and
    head."""
    return (vocab * d + max_len * d + depth * (12 * d * d + 13 * d) + 2 * d + d * d + d
            + d * classes + classes)


RAVEL_TILE = 8 * 1024
N_PARAMS = roberta_large_params()  # at S128, the CG/Neumann path
N_VECTOR = -(-N_PARAMS // RAVEL_TILE) * RAVEL_TILE  # the CG/Neumann path's vector length
N_RAGGED = 3 * RAVEL_TILE + 1000
TOL = {  # (forward, backward relative to max|reference|)
    "float32": (1e-5, 1e-4),
    "bfloat16": (1e-2, 2e-2),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


SLEEP_CYCLES = 50_000_000  # about 25 ms of the card's clock: longer than 20 calls' host work


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of one call of ``fn``: ``reps`` calls after
    ``warmup`` ones, between one pair of events, queued behind a kernel that
    sleeps while the host enqueues them, so that they run back to back on
    the device and the host's enqueue rate is not what is timed."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _free():
    """Return the memory of dropped objects to the card: ``Engine`` and each
    ``Problem`` refer to each other, so they are freed by the cyclic
    collector only, and ``empty_cache`` alone keeps their blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _inputs(dtype, case, gen, shape=SHAPE):
    import torch

    B, H, S, D = shape["B"], shape["H"], shape["S"], shape["D"]
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    if case == "padded":
        lengths = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
        mask = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
    elif case == "masked_row":
        mask[0, S // 2:] = False
        mask[1, :] = False
    return q, k, v, do, mask, case == "causal"


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (8 significant bits): 2^(e-8)
    for |x| = m 2^e with 0.5 <= m < 1, and at most the smallest normal's."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _single_check(dtype, shape, case, gen, worst):
    """B1 and B2 against their plain versions on one input; B2 is compared
    on the kernel's own o and lse. In bf16, B1's o is held elementwise to
    one bf16 ulp of the plain o: both round p against the row max, so only
    the order of float32 sums differs. Returns True if all agree."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    dname = str(dtype).split(".")[-1]
    tf, tb = TOL[dname]
    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    sm = 1.0 / math.sqrt(shape["D"])
    o, lse = fa._fwd_single(q, k, v, mask, causal=causal, sm_scale=sm)
    po, plse = fa._fwd_single_plain(q, k, v, mask, causal=causal, sm_scale=sm)
    torch.cuda.synchronize()
    scale_o = max(1.0, float(po.float().abs().max())) if dname == "bfloat16" else 1.0
    e_o, e_lse = _err(o, po), _err(lse, plse)
    ok_f = e_o <= tf * scale_o and e_lse <= tf * max(1.0, float(plse.abs().max()))
    ulp_note = ""
    if dname == "bfloat16":
        diff = (o.float() - po.float()).abs()
        in_ulps = diff / bf16_ulp(po)
        over = int((in_ulps > 1.0).sum())
        ok_f &= over == 0
        ulp_note = (f" share of o differing {float((diff > 0).float().mean()):.3e}, max "
                    f"{float(in_ulps.max()):.2f} bf16 ulp, {over} elements over 1 ulp;")
    if case == "masked_row":
        ok_f &= bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    dq, dk, dv = fa._bwd_single(q, k, v, do, o, lse, mask, causal=causal, sm_scale=sm)
    pq, pk, pv = fa._bwd_single_plain(q, k, v, do, o, lse, mask, causal=causal, sm_scale=sm)
    torch.cuda.synchronize()
    pairs = ((dq, pq), (dk, pk), (dv, pv))
    e_b = max(_err(a, b) / max(float(b.float().abs().max()), 1e-30) for a, b in pairs)
    ok_b = e_b <= tb and all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    worst["flash_single_fwd"] = max(worst["flash_single_fwd"], e_o)
    worst["flash_single_bwd"] = max(worst["flash_single_bwd"], *(_err(a, b) for a, b in pairs))
    geo = "B{B} H{H} S{S} D{D}".format(**shape)
    log(f"[kernels] B1/B2 {geo} {dname:8s} {case:10s} fwd |o|err {e_o:.3e} |lse|err "
        f"{e_lse:.3e} (tol {tf:g}{' x max|o|' if scale_o != 1.0 else ''});{ulp_note} "
        f"bwd rel err {e_b:.3e} (tol {tb:g}) -> {'ok' if ok_f and ok_b else 'FAIL'}")
    return ok_f and ok_b


def _dispatch_check(dtype, shape, case, gen, block, want_kernels):
    """``flash_attention`` forward and backward with ``block`` (None: the
    default) launches each kernel of ``want_kernels`` once and no other,
    and gives finite gradients. Returns a failure string or None."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    qg, kg, vg = (t.requires_grad_(True) for t in (q, k, v))
    fa.reset_launch_counts()
    out = fa.flash_attention(qg, kg, vg, mask, causal=causal, block_q=block, block_kv=block)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    counts = {name: f.launches for name, f in fa.KERNELS.items()}
    want = {name: int(name in want_kernels) for name in fa.KERNELS}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    dname = str(dtype).split(".")[-1]
    log(f"[kernels] flash_attention S{shape['S']} D{shape['D']} {dname} blocks "
        f"{block or 'default'}: launches {counts}; finite gradients {finite}")
    fa.reset_launch_counts()
    if counts != want or not finite:
        return f"S{shape['S']}/{dname}/dispatch {counts} finite {finite}"
    return None


def kernel_phase():
    """B1/B2 at the S128 path's shape for both dtypes and the four mask
    cases, then at the single-tile edge shapes, where ``flash_attention``
    with the default blocks must launch B1 and B2 and nothing else. Returns
    the largest absolute error of each kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"flash_single_fwd": 0.0, "flash_single_bwd": 0.0}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in MASK_CASES:
            if not _single_check(dtype, SHAPE, case, gen, worst):
                failures.append(f"S{SHAPE['S']}/{dtype}/{case}")
    for B, H, S, D, case in SINGLE_EDGE_SHAPES:
        shape = dict(B=B, H=H, S=S, D=D)
        for dtype in (torch.bfloat16, torch.float32):
            if not _single_check(dtype, shape, case, gen, worst):
                failures.append(f"S{S}/{dtype}/{case}")
            bad = _dispatch_check(dtype, shape, case, gen, None, SINGLE_KERNELS)
            if bad:
                failures.append(bad)
    _free()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return worst


def kernel_timings():
    """Times at the main path's inputs: all-true kv mask, not causal."""
    import torch
    import torch.nn.functional as F
    from betty_tpu_torch.ops import flash_attention as fa

    B, H, S, D = SHAPE["B"], SHAPE["H"], SHAPE["S"], SHAPE["D"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    sm = 1.0 / math.sqrt(D)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do, mask, _ = _inputs(dtype, "all_true", gen)
        o, lse = fa._fwd_single(q, k, v, mask, causal=False, sm_scale=sm)
        attn_mask = mask[:, None, None, :]
        t_fwd = time_ms(lambda: fa._fwd_single(q, k, v, mask, causal=False, sm_scale=sm))
        p_fwd = time_ms(lambda: fa._fwd_single_plain(q, k, v, mask, causal=False, sm_scale=sm))
        l_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
        t_bwd = time_ms(lambda: fa._bwd_single(q, k, v, do, o, lse, mask, causal=False,
                                               sm_scale=sm))
        p_bwd = time_ms(lambda: fa._bwd_single_plain(q, k, v, do, o, lse, mask, causal=False,
                                                     sm_scale=sm))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask)
        l_bwd = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))

        n = B * H * S * D
        item = q.element_size()
        mm = 2 * B * H * S * S * D  # flops of one (S x S x D) product per head
        fwd_bytes = 3 * n * item + mask.numel() + n * item + B * H * S * 4
        bwd_bytes = 5 * n * item + B * H * S * 4 + mask.numel() + 3 * n * item
        for name, t, p, lib, nbytes, flops in (
                ("flash_single_fwd", t_fwd, p_fwd, l_fwd, fwd_bytes, 2 * mm),
                ("flash_single_bwd", t_bwd, p_bwd, l_bwd, bwd_bytes, 5 * mm)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rows[(name, dname)] = dict(
                ms=t, plain_ms=p, library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"[timing] {name} {dname:8s} kernel {t:.4f} ms ({flops / t * 1e-9:.1f} "
                f"TFLOP/s)  plain {p:.4f} ms  "
                f"sdpa {'backward ' if name != 'flash_single_fwd' else ''}{lib:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return rows


MULTI_KERNELS = ("flash_multi_fwd", "flash_multi_bwd_dkv", "flash_multi_bwd_dq")
SINGLE_KERNELS = ("flash_single_fwd", "flash_single_bwd")
MASK_CASES = ("all_true", "padded", "masked_row", "causal")


def _multi_check(dtype, shape, case, gen, worst):
    """B3, B4 and B5 against their plain versions on one input. The plain
    forward runs at the kernel's own 64-row tiles, so p is rounded against
    the same running max; B4 and B5 are compared on the kernel's own o and
    lse, with di = rowsum(o * do) in float32 as the backward computes it.
    Tolerances as B1/B2's, but float32 B4 and B5 within 1e-5 x max|ref|:
    they are exact float32 FMAs, in the plain loop's order. Returns True if
    all agree."""
    import torch
    from betty_tpu_torch.ops import flash_attention as fa

    dname = str(dtype).split(".")[-1]
    tf, tb = TOL[dname]
    if dname == "float32":
        tb = FP32_MULTI_BWD_TOL
    q, k, v, do, mask, causal = _inputs(dtype, case, gen, shape)
    kw = dict(causal=causal, sm_scale=1.0 / math.sqrt(shape["D"]))
    tiles = dict(block_q=KERNEL_TILE, block_kv=KERNEL_TILE)
    o, lse = fa._fwd_multi(q, k, v, mask, **tiles, **kw)
    po, plse = fa._fwd_multi_plain(q, k, v, mask, **tiles, **kw)
    torch.cuda.synchronize()
    scale_o = max(1.0, float(po.float().abs().max())) if dname == "bfloat16" else 1.0
    e_o, e_lse = _err(o, po), _err(lse, plse)
    ok_f = e_o <= tf * scale_o and e_lse <= tf * max(1.0, float(plse.abs().max()))
    if case == "masked_row":
        ok_f &= bool((o[1] == 0).all()) and bool((lse[1] == 0).all())
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fa._bwd_dkv(q, k, v, do, lse, di, mask, **kw)
    dq = fa._bwd_dq(q, k, v, do, lse, di, mask, **kw)
    pk, pv = fa._bwd_dkv_plain(q, k, v, do, lse, di, mask, **kw)
    pq = fa._bwd_dq_plain(q, k, v, do, lse, di, mask, **kw)
    torch.cuda.synchronize()

    def rel(a, b):
        return _err(a, b) / max(float(b.float().abs().max()), 1e-30)

    e_dkv, e_dq = max(rel(dk, pk), rel(dv, pv)), rel(dq, pq)
    ok_b = (e_dkv <= tb and e_dq <= tb
            and all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv)))
    worst["flash_multi_fwd"] = max(worst["flash_multi_fwd"], e_o)
    worst["flash_multi_bwd_dkv"] = max(worst["flash_multi_bwd_dkv"], _err(dk, pk), _err(dv, pv))
    worst["flash_multi_bwd_dq"] = max(worst["flash_multi_bwd_dq"], _err(dq, pq))
    geo = "B{B} H{H} S{S} D{D}".format(**shape)
    log(f"[kernels] B3-B5 {geo} {dname:8s} {case:10s} fwd |o|err {e_o:.3e} |lse|err "
        f"{e_lse:.3e} (tol {tf:g}{' x max|o|' if scale_o != 1.0 else ''}) bwd rel err dk/dv "
        f"{e_dkv:.3e} dq {e_dq:.3e} (tol {tb:g}) -> {'ok' if ok_f and ok_b else 'FAIL'}")
    return ok_f and ok_b


def multi_kernel_phase():
    """B3-B5 at the long-sequence path's shape for both dtypes and the four
    mask cases, then at the edge shapes; there ``flash_attention`` with the
    edge's blocks must launch B3, B4 and B5 once each and neither B1 nor B2.
    Returns the largest absolute error of each kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = dict.fromkeys(MULTI_KERNELS, 0.0)
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in MASK_CASES:
            if not _multi_check(dtype, LONG_SHAPE, case, gen, worst):
                failures.append(f"S{LONG_SHAPE['S']}/{dtype}/{case}")
    for B, H, S, D, block, case in EDGE_SHAPES:
        shape = dict(B=B, H=H, S=S, D=D)
        for dtype in (torch.bfloat16, torch.float32):
            if not _multi_check(dtype, shape, case, gen, worst):
                failures.append(f"S{S}/{dtype}/{case}")
            bad = _dispatch_check(dtype, shape, case, gen, block, MULTI_KERNELS)
            if bad:
                failures.append(bad)
    _free()
    if failures:
        raise AssertionError(f"multi-tile kernels disagree with their plain versions: {failures}")
    return worst


def multi_kernel_timings():
    """B3-B5 at the long-sequence path's inputs (B8 H16 S1024 D64, all-true
    kv mask, not causal), beside their plain versions at the path's blocks
    (JAX's default 512) and PyTorch's ``scaled_dot_product_attention``: its
    forward for B3, its backward (which computes dq, dk and dv, the outputs
    of B4 and B5 together) for both B4 and B5."""
    import torch
    import torch.nn.functional as F
    from betty_tpu_torch.ops import flash_attention as fa

    B, H, S, D = (LONG_SHAPE[x] for x in "BHSD")
    gen = torch.Generator(device="cuda").manual_seed(4)
    kw = dict(causal=False, sm_scale=1.0 / math.sqrt(D))
    blocks = dict(block_q=fa.DEFAULT_BLOCK, block_kv=fa.DEFAULT_BLOCK)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v, do, mask, _ = _inputs(dtype, "all_true", gen, LONG_SHAPE)
        o, lse = fa._fwd_multi(q, k, v, mask, **blocks, **kw)
        di = (o.float() * do.float()).sum(-1)
        attn_mask = mask[:, None, None, :]
        bwd_args = (q, k, v, do, lse, di, mask)
        t_fwd = time_ms(lambda: fa._fwd_multi(q, k, v, mask, **blocks, **kw))
        p_fwd = time_ms(lambda: fa._fwd_multi_plain(q, k, v, mask, **blocks, **kw))
        l_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
        t_dkv = time_ms(lambda: fa._bwd_dkv(*bwd_args, **kw))
        p_dkv = time_ms(lambda: fa._bwd_dkv_plain(*bwd_args, **kw))
        t_dq = time_ms(lambda: fa._bwd_dq(*bwd_args, **kw))
        p_dq = time_ms(lambda: fa._bwd_dq_plain(*bwd_args, **kw))
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask)
        l_bwd = time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))

        n = B * H * S * D
        item = q.element_size()
        mm = 2 * B * H * S * S * D  # flops of one (S x S x D) product per head
        stats = B * H * S * 4  # one float32 value per row: lse or di
        for name, t, p, lib, nbytes, flops in (
                ("flash_multi_fwd", t_fwd, p_fwd, l_fwd,
                 3 * n * item + mask.numel() + n * item + stats, 2 * mm),
                ("flash_multi_bwd_dkv", t_dkv, p_dkv, l_bwd,
                 4 * n * item + 2 * stats + mask.numel() + 2 * n * item, 4 * mm),
                ("flash_multi_bwd_dq", t_dq, p_dq, l_bwd,
                 4 * n * item + 2 * stats + mask.numel() + n * item, 3 * mm)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            rows[(name, dname)] = dict(
                ms=t, plain_ms=p, library_ms=lib, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"[timing] {name} {dname:8s} kernel {t:.4f} ms ({flops / t * 1e-9:.1f} "
                f"TFLOP/s)  plain {p:.4f} ms  "
                f"sdpa {'backward ' if name != 'flash_multi_fwd' else ''}{lib:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms "
                f"({'bytes' if t_bytes >= t_ops else 'operations'})")
        t_bwd = t_dkv + t_dq
        log(f"[timing] flash_multi_bwd_dkv + flash_multi_bwd_dq {dname:8s} {t_bwd:.4f} ms "
            f"({7 * mm / t_bwd * 1e-9:.1f} TFLOP/s) against sdpa backward {l_bwd:.4f} ms")
        del q, k, v, do, o, lse, di, ql, kl, vl, ol, bwd_args
        _free()
    return rows


VECTOR_KERNELS = ("fused_dot2", "cg_fused_step", "neumann_fused_step")


def vector_phase():
    """B6-B8 against their plain versions at the path's length and at a
    ragged one. Elementwise outputs agree within 1e-6 x max|ref| (the kernels
    contract a*b+c into one fused multiply-add, the plain versions round the
    product first); dots within 1e-5 x sum|a_i b_i| (the kernels sum in
    another order). Times at the path's length, as ``time_ms``."""
    import torch
    from betty_tpu_torch.ops import vector as vec

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {name: {"max_abs_err": 0.0} for name in VECTOR_KERNELS}
    failures = []

    def elementwise(name, got, want, n):
        err = _err(got, want)
        tol = 1e-6 * float(want.abs().max())
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
        log(f"[vector] n={n} {name:18s} elementwise |err| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            failures.append(f"{name}/{n}")

    def dot(name, got, want, x, y, n):
        err = abs(float(got) - float(want))
        tol = 1e-5 * float((x * y).abs().sum())
        key = "max_abs_err" if name == "fused_dot2" else "dot_abs_err"
        rows[name][key] = max(rows[name].get(key, 0.0), err)
        log(f"[vector] n={n} {name:18s} dot {float(got):.6e} vs {float(want):.6e} "
            f"|err| {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            failures.append(f"{name}/{n}/dot")

    for n in (N_VECTOR, N_RAGGED):
        a, b, c, d = (torch.randn(n, generator=gen, device="cuda") for _ in range(4))
        ak = torch.rand((), generator=gen, device="cuda")
        alpha = 0.5
        for got, want, (x, y) in zip(vec.fused_dot2(a, b, c, d), vec.fused_dot2_plain(a, b, c, d),
                                     ((a, b), (c, d))):
            dot("fused_dot2", got, want, x, y, n)
        x2, r2, rr = vec.cg_fused_step(ak, a, b, c, d)
        px, pr, prr = vec.cg_fused_step_plain(ak, a, b, c, d)
        elementwise("cg_fused_step", x2, px, n)
        elementwise("cg_fused_step", r2, pr, n)
        dot("cg_fused_step", rr, prr, pr, pr, n)
        for got, want in zip(vec.neumann_fused_step(alpha, a, b, c),
                             vec.neumann_fused_step_plain(alpha, a, b, c)):
            elementwise("neumann_fused_step", got, want, n)
        torch.cuda.synchronize()
        if n == N_VECTOR:
            calls = {
                "fused_dot2": (lambda: vec.fused_dot2(a, b, c, d),
                               lambda: vec.fused_dot2_plain(a, b, c, d), 16 * n, 4 * n),
                "cg_fused_step": (lambda: vec.cg_fused_step(ak, a, b, c, d),
                                  lambda: vec.cg_fused_step_plain(ak, a, b, c, d),
                                  24 * n + 8, 6 * n),
                "neumann_fused_step": (lambda: vec.neumann_fused_step(alpha, a, b, c),
                                       lambda: vec.neumann_fused_step_plain(alpha, a, b, c),
                                       20 * n, 3 * n),
            }
            for name, (kernel, plain, nbytes, flops) in calls.items():
                t, pt = time_ms(kernel), time_ms(plain)
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS["float32"] * 1e3
                rows[name].update(ms=t, plain_ms=pt, library_ms=None,
                                  bound_ms=max(t_bytes, t_ops),
                                  bound_by="bytes" if t_bytes >= t_ops else "operations")
                log(f"[timing] {name} n={n} kernel {t:.4f} ms  plain {pt:.4f} ms  "
                    f"bound {max(t_bytes, t_ops):.4f} ms "
                    f"({'bytes' if t_bytes >= t_ops else 'operations'}); library: none "
                    "(no single PyTorch call computes it)")
        del a, b, c, d, x2, r2, px, pr
        _free()
    if failures:
        raise AssertionError(f"vector kernels disagree with their plain versions: {failures}")
    return rows


SMALL_ARGV = ["--dim", "64", "--depth", "2", "--heads", "4", "--seq_len", "16",
              "--batch_size", "4", "--train_size", "64", "--meta_size", "32",
              "--precision", "fp32", "--dropout", "0", "--unroll_steps", "2", "--train_iters",
              "4"]
SOLVER_CONFIG = {  # the fused loops at the iterations of the logistic-HPO example
    "sama": {},
    "cg": dict(use_fused_vector_ops=True, cg_iterations=3),
    "neumann": dict(use_fused_vector_ops=True, neumann_iterations=3),
}


def _counters(hypergradient):
    """``(reset, counters)``: a function that sets every kernel's launch
    count to 0, and the counters of the kernels that a solver's path runs."""
    from betty_tpu_torch.ops import flash_attention as fa
    from betty_tpu_torch.ops import vector as vec

    def reset():
        fa.reset_launch_counts()
        vec.reset_launch_counts()

    if hypergradient == "sama":
        return reset, dict(fa.KERNELS)
    if hypergradient == "cg":
        return reset, {"fused_dot2": vec.fused_dot2, "cg_fused_step": vec.cg_fused_step}
    return reset, {"neumann_fused_step": vec.neumann_fused_step}


def _used(hypergradient, seq_len, counters):
    """The kernels of ``counters`` that a run's path launches: SAMA's flash
    attention is single-tile up to the default block (512), multi-tile
    beyond; the vector kernels are all on their solver's path."""
    if hypergradient != "sama":
        return set(counters)
    return set(SINGLE_KERNELS if seq_len <= 512 else MULTI_KERNELS)


def small_run_phase(hypergradient, seq_len=16, batch=4):
    """The small fp32 reweighting run on the card (kernels) and on the CPU
    (their plain versions) from the same weights: parameters agree within
    1e-4 after 4 classifier and 2 reweight steps, as the CPU tests hold the
    port to the JAX package. SAMA runs with ``--flash`` (at S1024 through
    B3-B5, with B1/B2 launched no time), CG and Neumann on the plain
    attention with the fused vector loops."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    argv = SMALL_ARGV + ["--hypergradient", hypergradient]
    argv[argv.index("--seq_len") + 1] = str(seq_len)
    argv[argv.index("--batch_size") + 1] = str(batch)
    if hypergradient == "sama":
        argv.append("--flash")
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = ex.build_engine(ex.parse_args(argv + ["--device", dev]),
                                       **SOLVER_CONFIG[hypergradient])
    for name, st in engines["cpu"].states.items():
        engines["cuda"].states[name]["params"] = {k: v.to("cuda") for k, v in
                                                  st["params"].items()}
    reset, counters = _counters(hypergradient)
    reset()
    for eng in engines.values():
        eng.run()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    used = _used(hypergradient, seq_len, counters)
    assert all((n > 0) == (k in used) for k, n in launches.items()), launches
    err = max(float((engines["cuda"].states[n]["params"][k].cpu() - t).abs().max())
              for n, st in engines["cpu"].states.items() for k, t in st["params"].items())
    log(f"[small] {hypergradient} S{seq_len} B{batch}: card vs CPU after 4+2 steps: max |param "
        f"diff| {err:.3e} (tol 1e-4); launches {launches}")
    assert err <= 1e-4, err
    del engines
    _free()


def slice_phase(hypergradient, meta_periods=2, expected=None, profile=True, seq_len=128,
                batch=32):
    """Data reweighting of the RoBERTa-large encoder at B``batch``
    S``seq_len`` for ``meta_periods`` meta-periods, then (``profile``) one
    more under the profiler. Returns the launch counts of the path's kernels
    over the timed periods; ``expected`` gives exact counts to hold them
    to."""
    import torch
    from betty_tpu_torch.examples import bert_data_reweighting as ex

    unroll = 5
    argv = ["--model", "large", "--hypergradient", hypergradient, "--precision", "bf16",
            "--solver_precision", "fp32", "--unroll_steps", str(unroll),
            "--batch_size", str(batch), "--seq_len", str(seq_len), "--device_data",
            "--train_iters", str(unroll * meta_periods), "--train_size", "2048",
            "--meta_size", "512", "--device", "cuda"]
    if hypergradient == "sama":
        argv.append("--flash")
    tag = f"[slice {hypergradient}{'' if seq_len == 128 else f' S{seq_len}'}]"
    log(f"{tag} argv: {' '.join(argv)}; solver config {SOLVER_CONFIG[hypergradient]}")
    t0 = time.time()
    engine = ex.build_engine(ex.parse_args(argv), **SOLVER_CONFIG[hypergradient])
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in engine.states["classifier"]["params"].values())
    log(f"{tag} build_engine {time.time() - t0:.1f} s; classifier parameters {n_params}")
    assert n_params == roberta_large_params(max_len=seq_len), n_params

    losses = {"classifier": [], "reweight": []}
    period_ends = []  # host clock after each reweight step, device synchronised
    for prob in (engine.classifier, engine.reweight):
        orig = prob.one_step_descent

        def record(*a, _orig=orig, _name=prob.name, **kw):
            out = _orig(*a, **kw)
            losses[_name].append(out["loss"].detach())
            if _name == "reweight":
                torch.cuda.synchronize()
                period_ends.append(time.time())
            return out

        prob.one_step_descent = record
    rw_before = {k: t.clone() for k, t in engine.states["reweight"]["params"].items()}

    reset, counters = _counters(hypergradient)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the engine's state, and anything left from before
    reset()
    t0 = time.time()
    engine.run()
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    vals = {k: [float(x) for x in v] for k, v in losses.items()}
    log(f"{tag} losses {json.dumps(vals)}")
    log(f"{tag} counts classifier {engine.classifier.count} reweight {engine.reweight.count}")
    log(f"{tag} launches {launches}")
    periods = [b - a for a, b in zip([t0] + period_ends, period_ends)]
    log(f"{tag} meta-period seconds {periods} (the first includes warm-up); run "
        f"{elapsed:.3f} s; max_memory_allocated {peak / 2**30:.2f} GiB "
        f"({held / 2**30:.2f} GiB allocated when the run started)")
    assert engine.classifier.count == unroll * meta_periods, engine.classifier.count
    assert engine.reweight.count == meta_periods, engine.reweight.count
    assert all(math.isfinite(x) for v in vals.values() for x in v), vals
    assert len(vals["classifier"]) == unroll * meta_periods and len(vals["reweight"]) >= 2
    if expected is None:
        assert all(n > 0 for n in launches.values()), launches
    else:
        assert launches == expected, (launches, expected)
    changed = any(not torch.equal(rw_before[k], t)
                  for k, t in engine.states["reweight"]["params"].items())
    assert changed, "the reweight parameters did not change"
    finite = all(bool(torch.isfinite(t).all())
                 for s in engine.states.values() for t in s["params"].values())
    assert finite, "non-finite parameters after the run"
    if profile:
        profile_period(engine, unroll, tag)
    del engine
    _free()
    return launches


def profile_period(engine, unroll, tag):
    """One more meta-period under ``torch.profiler``: device time by kernel
    class, the flash kernels' split by input dtype, and the device's idle
    share over the period's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.train_iters = unroll
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((t / 1e3, e.count, e.key))
    busy = sum(t for t, _, _ in kernels)
    if busy == 0.0:
        log(f"{tag} [profile] the profiler recorded no device time")
        return

    def own(name):
        m = re.search(r"\(anonymous namespace\)::(\w+)[<(]", name)
        return m.group(1) if m and m.group(1) in KERNEL_SYMBOLS else None

    def kind(name):
        if own(name):
            return KERNEL_SYMBOLS[own(name)]
        if any(w in name.lower() for w in ("gemm", "xmma", "cutlass", "cublas", "matmul")):
            return "matmul"
        return "other"

    by_kind, by_dtype = {}, {}
    for t, c, name in kernels:
        k = kind(name)
        by_kind[k] = by_kind.get(k, 0.0) + t
        if k.startswith("flash"):
            # the tensor-core kernels (mma_*) take bf16, the others their type argument
            bf16 = own(name).startswith("mma_") or "__nv_bfloat16" in name
            key = (k, "bf16" if bf16 else "fp32")
            prev = by_dtype.get(key, (0.0, 0))
            by_dtype[key] = (prev[0] + t, prev[1] + c)
    log(f"{tag} [profile] profiled meta-period: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(c for _, c, _ in kernels)} kernel launches")
    for k, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"{tag} [profile]   {k:14s} {t:9.2f} ms  {t / busy:.3f} of device time")
    for (k, dt), (t, c) in sorted(by_dtype.items()):
        log(f"{tag} [profile]   {k} {dt}: {t:.2f} ms over {c} launches")
    for t, c, name in sorted(kernels, reverse=True)[:15]:
        log(f"{tag} [profile]   {t:9.2f} ms  x{c:<6d} {name[:110]}")


# the port's kernels by their own symbol names (csrc/*.cu), for the profile
KERNEL_SYMBOLS = {
    "fwd_kernel": "flash B1", "mma_fwd_single_kernel": "flash B1", "bwd_kernel": "flash B2",
    "mma_bwd_single_kernel": "flash B2", "fp32_fwd_kernel": "flash B3",
    "mma_fwd_kernel": "flash B3",
    "fp32_bwd_dkv_kernel": "flash B4", "fp32_bwd_dq_kernel": "flash B5",
    "mma_bwd_dkv_kernel": "flash B4", "mma_bwd_dq_kernel": "flash B5",
    "dot2_kernel": "vector (B6-B8)", "cg_step_kernel": "vector (B6-B8)",
    "neumann_step_kernel": "vector (B6-B8)", "sum_partials": "vector (B6-B8)",
}

REPLACES = {
    "flash_single_fwd": ("betty_tpu/ops/flash_attention.py:177",
                         "betty_tpu_torch/csrc/flash_single.cu"),
    "flash_single_bwd": ("betty_tpu/ops/flash_attention.py:209",
                         "betty_tpu_torch/csrc/flash_single.cu"),
    "flash_multi_fwd": ("betty_tpu/ops/flash_attention.py:373",
                        "betty_tpu_torch/csrc/flash_multi.cu"),
    "flash_multi_bwd_dkv": ("betty_tpu/ops/flash_attention.py:547",
                            "betty_tpu_torch/csrc/flash_multi.cu"),
    "flash_multi_bwd_dq": ("betty_tpu/ops/flash_attention.py:621",
                           "betty_tpu_torch/csrc/flash_multi.cu"),
    "fused_dot2": ("betty_tpu/ops/vector.py:85", "betty_tpu_torch/csrc/vector_ops.cu"),
    "cg_fused_step": ("betty_tpu/ops/vector.py:119", "betty_tpu_torch/csrc/vector_ops.cu"),
    "neumann_fused_step": ("betty_tpu/ops/vector.py:163", "betty_tpu_torch/csrc/vector_ops.cu"),
}


# the bf16 kernels that run on the tensor cores, by library
MMA_LIBS = {"flash_multi": ("mma_fwd_kernel", "mma_bwd_dkv_kernel", "mma_bwd_dq_kernel"),
            "flash_single": ("mma_fwd_single_kernel", "mma_bwd_single_kernel")}
MMA_KERNELS = tuple(k for kernels in MMA_LIBS.values() for k in kernels)
# the float32 multi-tile kernels on the CUDA cores (csrc/flash_fp32.cuh)
FP32_KERNELS = ("fp32_fwd_kernel", "fp32_bwd_dkv_kernel", "fp32_bwd_dq_kernel")
FP32_MULTI_BWD_TOL = 1e-5  # relative to max|ref|
MIN_FFMA_PER_LDS = 8


def _kernel_label(symbol):
    """``name<args>`` from the mangled symbol of a kernel in a source's
    anonymous namespace, e.g. ``mma_bwd_dkv_kernel<64>`` or
    ``multi_fwd_kernel<float,64>``; the symbol itself when it is not
    one of those."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", symbol)
    pos = m.end(1) + int(m.group(1)) if m else 0  # past the namespace's name
    n = m and re.match(r"\d+", symbol[pos:])
    if not n:
        return symbol
    start = pos + n.end()
    name, rest = symbol[start:start + int(n.group())], symbol[start + int(n.group()):]
    args = []
    if rest.startswith("I"):
        for tok in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f", rest[1:rest.find("EE") + 1]):
            args.append(tok.group(1) or ("bf16" if tok.group(0).startswith("13") else "float"))
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(build_logs):
    """Each kernel's registers and spills as ``ptxas -v`` reported them in
    ``build_logs`` (``{library: nvcc output}``); raises if a tensor-core
    kernel (``MMA_KERNELS``) or a float32 B3-B5 body (``FP32_KERNELS``)
    spills at D64."""
    spilled = []
    for lib, text in build_logs.items():
        current = None
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                current = _kernel_label(m.group(1))
                continue
            if current is None:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if sp:
                log(f"[setup] ptxas {lib} {current}: {line.strip()}")
                if current.split("<")[0] in MMA_KERNELS + FP32_KERNELS and current.endswith(
                        "<64>") and (int(sp.group(1)) or int(sp.group(2))):
                    spilled.append(current)
            elif "registers" in line:
                log(f"[setup] ptxas {lib} {current}: {line.split(':', 1)[-1].strip()}")
    if spilled:
        raise AssertionError(f"kernels spill at D64: {spilled}")


SASS_INS = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _product_loops(ins):
    """The innermost loops of a kernel's SASS (``ins``: ``(address, opcode,
    operands)`` in order) that hold FFMA: ``[(first, last, FFMA, shared
    loads, of which LDS.128)]``; a loop is the span of a backward branch."""
    spans = []
    for addr, op, args in ins:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [a for a in spans if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in spans)]
    loops = []
    for lo, hi in inner:
        body = [op for addr, op, _ in ins if lo <= addr <= hi]
        ffma = sum(op.split(".")[0] == "FFMA" for op in body)
        lds = sum(op.split(".")[0] == "LDS" for op in body)
        if ffma:
            loops.append((lo, hi, ffma, lds, sum(op == "LDS.128" for op in body)))
    return loops


def sass_report(lib_paths, head_dims):
    """From each built library's SASS (``cuobjdump --dump-sass``;
    ``lib_paths``: ``{library: path}``): the tensor-core instructions
    (``HMMA``) of each tensor-core kernel of ``MMA_LIBS`` at every head dim
    in ``head_dims``, which must not be 0; and the ``FFMA``, ``LDS`` (any
    width) and ``LDS.128`` instructions of the float32 B3, B4 and B5
    (``FP32_KERNELS``), in all and in each product loop (an innermost loop
    that holds FFMA), which at D64 must do at least ``MIN_FFMA_PER_LDS``
    FFMA per shared-memory load, with no ``HMMA`` in the kernel."""
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"),
             "cuobjdump"]
    tool = next((t for t in tools if os.path.isfile(t)), "cuobjdump")
    bad = []
    for lib, kernels in MMA_LIBS.items():
        out = subprocess.run([tool, "--dump-sass", str(lib_paths[lib])], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"cuobjdump failed ({out.returncode}): {out.stderr[-2000:]}")
        code, current = {}, None
        for line in out.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = _kernel_label(m.group(1))
                code[current] = []
                continue
            ins = SASS_INS.search(line) if current is not None else None
            if ins:
                code[current].append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
        for k, ins in sorted(code.items()):
            ops = [op.split(".")[0] for _, op, _ in ins]
            hmma = ops.count("HMMA")
            if k.split("<")[0] not in FP32_KERNELS:
                log(f"[setup] sass {lib} {k}: {hmma} HMMA instructions")
                continue
            n_lds128 = sum(op == "LDS.128" for _, op, _ in ins)
            log(f"[setup] sass {lib} {k}: {ops.count('FFMA')} FFMA, {ops.count('LDS')} LDS of "
                f"which {n_lds128} LDS.128, {hmma} HMMA")
            loops = _product_loops(ins)
            for lo, hi, ffma, lds, lds128 in loops:
                log(f"[setup] sass {lib} {k}:   product loop {lo:#x}-{hi:#x}: {ffma} FFMA, "
                    f"{lds} LDS of which {lds128} LDS.128 ({ffma / max(lds, 1):.2f} FFMA per "
                    "shared load)")
            if k.endswith("<64>"):
                if hmma or not loops:
                    bad.append(f"{lib} {k}: {hmma} HMMA, {len(loops)} product loops")
                bad += [f"{lib} {k}: loop {lo:#x} at {ffma / max(lds, 1):.2f} FFMA per LDS"
                        for lo, _, ffma, lds, _ in loops if ffma < MIN_FFMA_PER_LDS * lds]
        bad += [f"{lib} {kernel}<{d}>: no HMMA" for kernel in kernels for d in head_dims
                if not any(op.startswith("HMMA") for _, op, _ in code.get(f"{kernel}<{d}>", []))]
        if lib == "flash_multi":
            bad += [f"{lib} {kernel}<{d}>: not in the SASS" for kernel in FP32_KERNELS
                    for d in head_dims if f"{kernel}<{d}>" not in code]
    if bad:
        raise AssertionError(f"kernels without the instructions of their design: {bad}")


PHASES = ("kernels", "slice", "long")
# exact launch counts of the two SAMA runs over two meta-periods: per period
# 216 attention forwards and 144 backwards (5 bf16 classifier steps of 24
# layers, then SAMA's fp32 passes), one kernel each, B4 and B5 both per
# backward
SAMA_S128 = {"flash_single_fwd": 432, "flash_single_bwd": 288, "flash_multi_fwd": 0,
             "flash_multi_bwd_dkv": 0, "flash_multi_bwd_dq": 0}
SAMA_S1024 = {"flash_single_fwd": 0, "flash_single_bwd": 0, "flash_multi_fwd": 432,
              "flash_multi_bwd_dkv": 288, "flash_multi_bwd_dq": 288}


def _flash_row(name, worst, rows, launches):
    r = rows[(name, "bfloat16")]
    row = {
        "name": name, "route": "cuda", "source": REPLACES[name][1],
        "replaces": REPLACES[name][0], "launches": launches[name],
        "max_abs_err": worst[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "float32": {k: rows[(name, "float32")][k]
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }
    if name in ("flash_multi_bwd_dkv", "flash_multi_bwd_dq"):
        row["library_computes"] = "dq, dk and dv: the outputs of B4 and B5 together"
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="kernels (always run), slice (S128 runs), long (S1024 runs)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(",")) | {"kernels"}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        from betty_tpu_torch.ops import _build
        from betty_tpu_torch.ops import flash_attention as fa
        from betty_tpu_torch.ops import vector as vec
    except ImportError as e:
        print(f"chip_smoke: the betty_tpu_torch package is not here ({e})", file=sys.stderr)
        return 3

    card = card_line()
    log(f"[setup] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.time()
    libs = _build.build_all()
    fa._lib("flash_single")
    fa._lib("flash_multi")
    vec._lib()
    log(f"[setup] kernels built in {time.time() - t0:.1f} s (parallel): "
        + ", ".join(f"{k} {_build.BUILD_SECONDS.get(k, 0.0):.1f} s -> {v}"
                    for k, v in libs.items()))
    ptxas_report(_build.BUILD_LOGS)
    sass_report(libs, fa.KERNEL_HEAD_DIMS)

    worst = kernel_phase()
    rows = kernel_timings()
    worst.update(multi_kernel_phase())
    rows.update(multi_kernel_timings())
    vrows = vector_phase()
    # each kernel's launches come from its own path's run
    launches = {name: None for name in REPLACES}
    if "slice" in phases:
        for hypergradient in ("sama", "cg", "neumann"):
            small_run_phase(hypergradient)
        sama = slice_phase("sama", expected=SAMA_S128)
        launches.update({k: sama[k] for k in SINGLE_KERNELS})
        launches.update(slice_phase("cg", expected={"fused_dot2": 2, "cg_fused_step": 6}))
        launches.update(slice_phase("neumann", expected={"neumann_fused_step": 6},
                                    profile=False))
    if "long" in phases:
        small_run_phase("sama", seq_len=1024, batch=2)
        sama = slice_phase("sama", expected=SAMA_S1024, seq_len=1024, batch=8)
        launches.update({k: sama[k] for k in MULTI_KERNELS})

    kernels = [_flash_row(name, worst, rows, launches) for name in SINGLE_KERNELS + MULTI_KERNELS]
    for name in VECTOR_KERNELS:
        r = vrows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": REPLACES[name][1],
            "replaces": REPLACES[name][0], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            **({"dot_abs_err": r["dot_abs_err"]} if "dot_abs_err" in r else {}),
            "n": N_VECTOR,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)} only: no result line")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
