"""Single-tile flash attention: hand-written CUDA kernels for Hopper, their
plain PyTorch versions, and the autograd function around them.

Counterpart of ``betty_tpu/ops/flash_attention.py``'s single-tile path,
which runs whenever the sequence fits one 512-row block:

* ``_fwd_single`` launches ``flash_single_fwd`` (``csrc/flash_single.cu``),
  the port of the Pallas kernel ``_fwd_single_kernel``: o and the per-row
  logsumexp ``lse`` of shape (B, H, S) in float32.
* ``_bwd_single`` launches ``flash_single_bwd``, the port of
  ``_bwd_single_kernel``: dq, dk, dv with ``di = rowsum(o * do)`` computed
  in the kernel.

On a CPU tensor each wrapper computes its kernel's plain version
(``_fwd_single_plain`` / ``_bwd_single_plain``), which repeats the kernel's
arithmetic: products in the input dtype with float32 accumulation, p and ds
rounded to the input dtype where the kernels round them. On a CUDA tensor it
launches the kernel or raises; nothing falls back. Sequences longer than 512
need the multi-tile kernels, which are not ported yet.

``FlashAttentionFn`` is reverse-mode only, like the JAX ``custom_vjp``:
``torch.func.jvp`` through it raises, so the Hessian-vector solvers (CG,
Neumann) run the plain attention, ``reference_attention``, which carries
flax's attention-probability dropout in train mode.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` beside the package (or ``$BETTY_TORCH_BUILD_DIR``) and
loaded with ``ctypes`` (``ops/_build.py``).
"""

import ctypes
import math
from pathlib import Path

import torch

from betty_tpu_torch.ops import _build

# -0.7 * max float32: large enough to vanish in exp, without -inf NaN traps
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# longest sequence the single-tile kernels take (the JAX default block)
MAX_SINGLE_TILE = 512
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_NAME = "flash_single"
BUILD_LOG = ""  # nvcc's output of the last build (ptxas register/smem report)


def build_kernels() -> Path:
    """Compile ``csrc/flash_single.cu`` into a shared library keyed by the
    source's hash; a library already built from the same source is reused."""
    global BUILD_LOG
    out = _build.build_all([_NAME])[_NAME]
    BUILD_LOG = _build.BUILD_LOGS.get(_NAME, BUILD_LOG)
    return out


def _lib():
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load(_NAME, {
        "flash_single_fwd": ([p] * 6 + [i] * 7 + [f, p], i),
        "flash_single_bwd": ([p] * 11 + [i] * 7 + [f, p], i),
    })


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# plain versions (what the kernels compute)
# ---------------------------------------------------------------------------


def _acc(x):
    """Accumulation dtype: float32, or float64 for float64 inputs."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _tile_mask(kv_mask, Sq, Skv, causal, device):
    """(B or 1, 1, Sq, Skv) bool mask (or None) from causal geometry and kv
    padding."""
    mask = None
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device).tril()[None, None]
    if kv_mask is not None:
        kvm = kv_mask.to(torch.bool)[:, None, None, :]
        mask = kvm if mask is None else (mask & kvm)
    return mask


def _fwd_single_plain(q, k, v, kv_mask, *, causal, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * sm_scale
    mask = _tile_mask(kv_mask, q.shape[2], k.shape[2], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = torch.einsum("bhqk,bhkd->bhqd", _acc(p.to(v.dtype)), _acc(v))
    o = (pv / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, 0.0, m + torch.log(l_safe))[..., 0]
    return o, lse.to(torch.promote_types(q.dtype, torch.float32))


def _bwd_single_plain(q, k, v, do, o, lse, kv_mask, *, causal, sm_scale):
    di = (_acc(o) * _acc(do)).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * sm_scale
    mask = _tile_mask(kv_mask, q.shape[2], k.shape[2], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", _acc(p.to(do.dtype)), _acc(do)).to(v.dtype)
    dp = torch.einsum("bhqd,bhkd->bhqk", _acc(do), _acc(v))
    ds = _acc((p * (dp - di) * sm_scale).to(q.dtype))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _acc(k)).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)).to(k.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_kernel_inputs(q, k, v, kv_mask):
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if Sq > MAX_SINGLE_TILE or Skv > MAX_SINGLE_TILE:
        raise NotImplementedError(
            f"flash_attention on CUDA: sequence {Sq}x{Skv} exceeds the single-tile "
            f"limit {MAX_SINGLE_TILE}; the multi-tile kernels (B3 _fwd_kernel, "
            "B4 _bwd_dkv_kernel, B5 _bwd_dq_kernel) are not ported yet")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS or k.shape != (B, H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernels: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} (head_dim in "
                         f"{KERNEL_HEAD_DIMS})")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Skv):
        raise ValueError(f"kv_mask must be (B, Skv) = {(B, Skv)}, got {tuple(kv_mask.shape)}")


def _mask_bytes(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.bool).contiguous()


def _fwd_single(q, k, v, kv_mask, *, causal, sm_scale):
    """B1: ``(o, lse)``; the kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return _fwd_single_plain(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, kv_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = _mask_bytes(kv_mask)
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_single_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse), B, H, Sq, k.shape[2], D,
        int(q.dtype == torch.bfloat16), int(causal), float(sm_scale), stream)
    _check(err, "flash_single_fwd")
    _fwd_single.launches += 1
    return o, lse


_fwd_single.launches = 0


def _bwd_single(q, k, v, do, o, lse, kv_mask, *, causal, sm_scale):
    """B2: ``(dq, dk, dv)``; the kernel on CUDA, the plain version on the
    CPU."""
    if q.device.type == "cpu":
        return _bwd_single_plain(q, k, v, do, o, lse, kv_mask, causal=causal,
                                 sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, kv_mask)
    if do.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention backward: do/o/lse shapes do not match q")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    o, lse = o.contiguous(), lse.to(torch.float32).contiguous()
    mask = _mask_bytes(kv_mask)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if Skv > 64 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_single_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(o), _ptr(lse), _ptr(mask), _ptr(dq),
        _ptr(dk), _ptr(dv), _ptr(dq_acc), B, H, Sq, Skv, D, int(q.dtype == torch.bfloat16),
        int(causal), float(sm_scale), stream)
    _check(err, "flash_single_bwd")
    _bwd_single.launches += 1
    return dq, dk, dv


_bwd_single.launches = 0


def reset_launch_counts():
    _fwd_single.launches = 0
    _bwd_single.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom VJP: saves q, k, v, the mask,
    o and lse; the backward is the B2 kernel. No forward-mode rule."""

    @staticmethod
    def forward(q, k, v, kv_mask, causal, sm_scale):
        return _fwd_single(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kv_mask, causal, sm_scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_single(q, k, v, do, o, lse, kv_mask, causal=ctx.causal,
                                 sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask=None, *, causal=False, sm_scale=None):
    """``softmax(q k^T * sm_scale) v`` through the single-tile kernels.

    q, k, v: ``(batch, heads, seq, head_dim)``, float32 or bfloat16 on CUDA
    (any float dtype on the CPU). ``kv_mask``: optional ``(batch, kv_seq)``
    bool, True where keys are valid; query rows are not masked. ``causal``:
    lower-triangular masking. ``sm_scale`` defaults to ``1/sqrt(head_dim)``.
    Reverse-mode differentiable only.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = FlashAttentionFn.apply(q, k, v, kv_mask, bool(causal), float(sm_scale))
    return o


def reference_attention(q, k, v, kv_mask=None, *, causal=False, sm_scale=None,
                        dropout_rate=0.0, generator=None):
    """Plain einsum attention with the same mask semantics: the numeric
    oracle for the kernels and the non-flash path.

    With a ``generator`` and ``dropout_rate > 0`` the float32 probabilities
    get flax's attention dropout (``broadcast_dropout=True``): one
    ``(1, 1, Sq, Skv)`` keep mask shared by every batch element and head,
    kept values scaled by ``1 / (1 - dropout_rate)``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * sm_scale
    mask = _tile_mask(kv_mask, q.shape[2], k.shape[2], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    if generator is not None and dropout_rate > 0.0:
        keep = torch.rand((1, 1) + tuple(p.shape[2:]), generator=generator,
                          device=p.device) >= dropout_rate
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, _acc(v)).to(q.dtype)
