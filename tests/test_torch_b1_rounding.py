"""Why bf16 B1 on the tensor cores takes three things again as float32
chains (``csrc/flash_mma.cuh::mma_fwd_q_tile<D, true>``), on the CPU.

The plain version (``_fwd_single_plain``) runs its two products on the card
as float32 SIMT matrix products: chains of fmaf, d (or j) ascending. The
tensor cores (``mma.sync`` m16n8k16) sum 16 exact bf16 products and the
accumulator aligned to the largest and cut to 24 bits, rounding toward
zero. This file emulates both in numpy on randn inputs and holds the
kernel's guards to what the emulation shows:

* p from the tensor-core s by 2^(s scale log2 e - m log2 e) lies fewer
  float32 ulps from the plain p than ``PFLIP_ULPS``, the distance from a
  bf16 rounding midpoint within which the kernel takes p again from the
  chain (the SFU's ex2 adds about 2 ulps, not emulated);
* where |acc| >= ``O_FLAG`` sum_j p_j |v_jd| the two sums of p V differ by
  less than a bf16 ulp of acc;
* with the guards (row max, p near a midpoint, o that nearly cancels from
  the chains), no element of o is more than one bf16 ulp from the plain o.

Both constants are read from the source. Run as a script for the counts at
B1's S128 D64 shape (``python tests/test_torch_b1_rounding.py``, about a
minute).
"""

import re
from pathlib import Path

import numpy as np
import pytest

SOURCE = Path(__file__).resolve().parents[1] / "betty_tpu_torch" / "csrc" / "flash_mma.cuh"
MASK_VALUE = np.float32(-0.7 * np.finfo(np.float32).max)


def _constants():
    text = SOURCE.read_text()
    ulps = int(re.search(r"constexpr int PFLIP_ULPS = (\d+);", text).group(1))
    m = re.search(r"constexpr float O_FLAG = 1\.f / (\d+)\.f;", text)
    return ulps, 1.0 / int(m.group(1))


def bf16(x):
    """float32 rounded to bf16 (nearest even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


def ulp(x):
    """One bf16 ulp at each element, as chip_smoke.py's ``bf16_ulp``."""
    _, e = np.frexp(np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0 ** -126)))
    return np.ldexp(1.0, e - 8)


def chain(a, b):
    """sum_d a[..., d] b[..., d] as float32 fmaf chains, d ascending (bf16
    products are exact in float32, so fmaf is one rounded add)."""
    acc = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-1], np.float32)
    for d in range(a.shape[-1]):
        acc = (acc + a[..., d] * b[..., d]).astype(np.float32)
    return acc


def _rz32(x):
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tensor_core(a, b, bits=24):
    """sum_d a[..., d] b[..., d] as mma.sync k-steps of 16: the products and
    the accumulator truncated to ``bits`` below the largest, summed, and
    the sum cut to float32 toward zero."""
    prods = a.astype(np.float64) * b.astype(np.float64)
    acc = np.zeros(prods.shape[:-1], np.float32)
    for k0 in range(0, prods.shape[-1], 16):
        terms = np.concatenate([acc[..., None].astype(np.float64), prods[..., k0:k0 + 16]], -1)
        _, e = np.frexp(np.abs(terms).max(-1))
        quantum = np.ldexp(1.0, e - bits)[..., None]
        acc = _rz32((np.trunc(terms / quantum) * quantum).sum(-1))
    return acc


def _head(rng, S, D, padded):
    q, k, v = (bf16(rng.standard_normal((S, D)).astype(np.float32)) for _ in range(3))
    keep = np.ones(S, bool)
    if padded:
        keep[rng.integers(S // 4, S):] = False
    return q, k, v, keep


def _softmax_pv(x, keep, v, pv):
    m = np.where(keep, x, MASK_VALUE).max(-1, keepdims=True)
    p = np.where(keep, np.exp((x - m).astype(np.float32)), np.float32(0)).astype(np.float32)
    return m, p, pv(bf16(p), v)


def emulate(S, D, heads, padded=False, seed=0):
    """Counts over ``heads`` heads of S x D: the plain version against the
    tensor cores without guards, with exact p, and with the kernel's
    guards."""
    p_ulps, o_flag = _constants()
    rng = np.random.default_rng(seed)
    scale = np.float32(1 / np.sqrt(D))
    out = dict(o=0, s_differ=0, scores=0, p_flips=0, over_plain_tc=0, over_exact_p=0,
               over_guarded=0, max_p_ulps=0, max_acc_err=0.0, p_again=0, o_again=0)
    for _ in range(heads):
        q, k, v, keep = _head(rng, S, D, padded)
        vt = v.T[None]
        x_ch = (chain(q[:, None], k[None]) * scale).astype(np.float32)
        s_tc = tensor_core(q[:, None], k[None])
        x_tc = (s_tc * scale).astype(np.float32)
        pv_ch = lambda pb, v_: chain(pb[:, None], vt)  # noqa: E731
        pv_tc = lambda pb, v_: tensor_core(pb[:, None], vt)  # noqa: E731
        m, p, acc = _softmax_pv(x_ch, keep, v, pv_ch)
        l = p.sum(-1, keepdims=True, dtype=np.float32)
        o = bf16((acc / l).astype(np.float32))

        def over(o_k):
            return int((np.abs(o_k - o) > ulp(o)).sum())

        _, p_t, acc_t = _softmax_pv(x_tc, keep, v, pv_tc)
        out["over_plain_tc"] += over(bf16((acc_t / p_t.sum(-1, keepdims=True)).astype(np.float32)))
        out["p_flips"] += int((bf16(p_t) != bf16(p)).sum())
        out["over_exact_p"] += over(bf16((pv_tc(bf16(p), v) / l).astype(np.float32)))
        out["s_differ"] += int((x_ch != x_tc)[:, keep].sum())
        out["scores"] += int(keep.sum()) * S
        out["o"] += S * D

        # the kernel: the row max from the chain near the tensor-core max
        m_tc = np.where(keep, x_tc, MASK_VALUE).max(-1, keepdims=True)
        near = keep & (x_tc >= m_tc - np.maximum(1, np.abs(m_tc)) / 4096)
        m_k = np.where(near, x_ch, -np.inf).max(-1, keepdims=True)
        assert (m_k == m).all()
        # p = 2^(s scale log2 e - m log2 e) from the tensor-core s (the
        # exponent one fmaf; the SFU's ex2 taken as exact), then again from
        # the chain's s near a bf16 rounding midpoint
        log2e = np.float32(np.log2(np.e))
        z = (s_tc.astype(np.float64) * np.float64(np.float32(scale * log2e))
             - np.float64(np.float32(m_k * log2e))).astype(np.float32)
        p_k = np.where(keep, np.exp2(z.astype(np.float64)).astype(np.float32), np.float32(0))
        low = (p_k.view(np.uint32) & 0xFFFF).astype(np.int64) - 0x8000
        again = keep & (np.abs(low) <= p_ulps)
        dist = np.abs(p_k.view(np.uint32).astype(np.int64) - p.view(np.uint32))
        out["max_p_ulps"] = max(out["max_p_ulps"], int(dist[keep].max()))
        p_k = np.where(again, p, p_k)
        out["p_again"] += int(again.sum())
        pb = bf16(p_k)
        assert (pb == bf16(p)).all()
        # o again from the chain where the sum nearly cancels
        acc_k = pv_tc(pb, v)
        bound = pb.astype(np.float64) @ np.abs(v.astype(np.float64))
        err = np.abs(acc_k - acc.astype(np.float64)) / np.maximum(bound, 1e-300)
        out["max_acc_err"] = max(out["max_acc_err"], float(err.max()))
        flag = np.abs(acc_k) < o_flag * bound
        out["o_again"] += int(flag.sum())
        acc_k = np.where(flag, acc, acc_k)
        l_k = p_k[:, ::-1].sum(-1, keepdims=True, dtype=np.float32)  # another order
        out["over_guarded"] += over(bf16((acc_k / l_k).astype(np.float32)))
    return out


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("padded", [False, True], ids=["all_true", "padded"])
def test_guarded_tensor_core_b1_stays_within_one_ulp(D, padded):
    """With the kernel's guards no emulated o element is past one bf16 ulp
    of the plain o; the guards' margins hold: p moved by under half of
    PFLIP_ULPS, and the two sums of p V differ by under 2^-19 of
    sum_j p_j |v_jd| (half the 2^-18 below a bf16 ulp of acc wherever
    O_FLAG does not flag it)."""
    p_ulps, _ = _constants()
    out = emulate(128, D, heads=2, padded=padded, seed=D)
    assert out["over_guarded"] == 0, out
    assert out["max_p_ulps"] < p_ulps // 2, out
    assert out["max_acc_err"] < 2.0 ** -19, out


def main():
    out = emulate(128, 64, heads=256)
    n_o, n_s = out.pop("o"), out.pop("scores")
    print(f"S128 D64, 256 heads ({n_o} o elements, {n_s} scores):")
    for key, val in out.items():
        share = val / (n_s if key in ("s_differ", "p_flips", "p_again") else n_o)
        print(f"  {key:14s} {val}" + ("" if key.startswith("max") else f"  ({share:.3e})"))


if __name__ == "__main__":
    main()
