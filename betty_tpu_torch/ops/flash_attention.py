"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd function around them.

Counterpart of ``betty_tpu/ops/flash_attention.py``, with its dispatch:
``block_q``/``block_kv`` default to ``min(512, S)``; the single-tile path
runs iff ``Sq <= block_q and Skv <= block_kv``, in the forward and in the
backward alike; otherwise each sequence must divide by its block (the same
``ValueError`` as JAX's ``_blocks``, on every device) and the multi-tile
path runs.

* single tile: ``_fwd_single`` launches ``flash_single_fwd``
  (``csrc/flash_single.cu``), the port of ``_fwd_single_kernel`` (B1): o and
  the per-row logsumexp ``lse`` of shape (B, H, S) in float32 (in bf16 on
  the tensor cores, up to ``SINGLE_MAX_KV`` keys, in float32 on the CUDA
  cores);
  ``_bwd_single`` launches ``flash_single_bwd``, the port of
  ``_bwd_single_kernel`` (B2): dq, dk, dv with ``di = rowsum(o * do)``
  computed in the kernel (in bf16 on the tensor cores with dq in
  registers, in float32 with a float32 dq scratch).
* multi-tile: ``_fwd_multi`` launches ``flash_multi_fwd``
  (``csrc/flash_multi.cu``), the port of ``_fwd_kernel`` (B3); the backward
  computes ``di`` once in PyTorch and feeds it to ``_bwd_dkv``
  (``flash_multi_bwd_dkv``, the port of ``_bwd_dkv_kernel``, B4) and
  ``_bwd_dq`` (``flash_multi_bwd_dq``, the port of ``_bwd_dq_kernel``, B5);
  in bf16 all three run on the tensor cores, in float32 on the CUDA cores.
  The kernels tile by 64 rows whatever the blocks are; the blocks choose the
  path and the plain versions' tiles.

JAX's VMEM feasibility test (``_pick_block_h``) and its fallback blocks
(``_clamp_blocks``) have no counterpart: they exist because a TPU program
holds a whole (heads, S, S) score block in VMEM, while the CUDA single-tile
kernels walk 64-row tiles and take every sequence that fits the blocks.

On a CPU tensor each wrapper computes its kernel's plain version (``*_plain``
below), which repeats the kernel's arithmetic: products in the input dtype
with float32 accumulation, p and ds rounded to the input dtype where the
kernels round them, B3's p rounded against the running max of its KV tile.
On a CUDA tensor it launches the kernel or raises; nothing falls back. Each
wrapper counts its launches in ``.launches``; ``reset_launch_counts`` sets
all five to 0.

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

import torch

from betty_tpu_torch.ops import _build

# -0.7 * max float32: large enough to vanish in exp, without -inf NaN traps
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the JAX default block: sequences up to it take the single-tile path
DEFAULT_BLOCK = 512
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the most keys the bf16 B1 kernel takes: it keeps its rows' rounded p in
# shared memory (csrc/flash_mma.cuh, SINGLE_MAX_KV)
SINGLE_MAX_KV = 1024


def _lib(name):
    """The library of ``csrc/<name>.cu`` (``flash_single`` or
    ``flash_multi``), built at first use."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "flash_single": {
            "flash_single_fwd": ([p] * 6 + [i] * 7 + [f, p], i),
            "flash_single_bwd": ([p] * 11 + [i] * 7 + [f, p], i),
        },
        "flash_multi": {
            "flash_multi_fwd": ([p] * 6 + [i] * 7 + [f, p], i),
            "flash_multi_bwd_dkv": ([p] * 9 + [i] * 7 + [f, p], i),
            "flash_multi_bwd_dq": ([p] * 8 + [i] * 7 + [f, p], i),
        },
    }
    return _build.load(name, signatures[name])


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
    """B1: the softmax over the whole key sequence, p rounded against the
    row max: B3's plain version with one tile (its running max is then the
    row max, and its rescaling multiplies zeros)."""
    return _fwd_multi_plain(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                            block_q=q.shape[2], block_kv=k.shape[2])


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


def _fwd_multi_plain(q, k, v, kv_mask, *, causal, sm_scale, block_q, block_kv):
    """B3: KV tiles of ``block_kv`` with the online softmax; p is rounded to
    the input dtype against the running max, as the kernel rounds it. The
    kernel's tiles are 64 rows: with ``block_kv=64`` the rounding points
    coincide. ``block_q`` only decides the causal tile skip, which changes
    nothing here (a skipped tile is wholly masked), so every row runs every
    tile."""
    del block_q
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    qa = _acc(q)
    f = qa.dtype
    mask = _tile_mask(kv_mask, Sq, Skv, causal, q.device)
    m = torch.full((B, H, Sq, 1), -math.inf, dtype=f, device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=f, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=f, device=q.device)
    for k0 in range(0, Skv, block_kv):
        k1 = min(k0 + block_kv, Skv)
        s = torch.einsum("bhqd,bhkd->bhqk", qa, _acc(k[:, :, k0:k1])) * sm_scale
        tile = None if mask is None else mask[..., k0:k1]
        if tile is not None:
            s = torch.where(tile, s, MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        if tile is not None:
            p = torch.where(tile, p, 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bhkd->bhqd", _acc(p.to(v.dtype)), _acc(v[:, :, k0:k1]))
        acc = acc * alpha + pv
        m = m_next
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe).to(q.dtype)
    lse = torch.where(l == 0.0, 0.0, m + torch.log(l_safe))[..., 0]
    return o, lse


def _bwd_probs(q, k, v, do, lse, di, kv_mask, causal, sm_scale):
    """p = exp(s - lse), zeroed where masked (after the exp, as B4/B5), and
    ds = p (dp - di) scale rounded to the input dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * sm_scale
    p = torch.exp(s - lse[..., None])
    mask = _tile_mask(kv_mask, q.shape[2], k.shape[2], causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", _acc(do), _acc(v))
    ds = _acc((p * (dp - di[..., None]) * sm_scale).to(q.dtype))
    return p, ds


def _bwd_dkv_plain(q, k, v, do, lse, di, kv_mask, *, causal, sm_scale):
    """B4: ``(dk, dv)`` from ``lse`` and ``di = rowsum(o * do)``."""
    p, ds = _bwd_probs(q, k, v, do, lse, di, kv_mask, causal, sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", _acc(p.to(do.dtype)), _acc(do)).to(v.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _acc(q)).to(k.dtype)
    return dk, dv


def _bwd_dq_plain(q, k, v, do, lse, di, kv_mask, *, causal, sm_scale):
    """B5: ``dq`` from ``lse`` and ``di``."""
    _, ds = _bwd_probs(q, k, v, do, lse, di, kv_mask, causal, sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, _acc(k)).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch and kernel wrappers
# ---------------------------------------------------------------------------


def _blocks(seq, block, what):
    """JAX's ``_blocks``: the block clamped to the sequence, which must
    divide by it."""
    block = min(block, seq)
    if seq % block != 0:
        raise ValueError(
            f"{what}: sequence length {seq} must be divisible by the "
            f"block size {block} (pad the sequence)")
    return block


def _multi_tile_blocks(Sq, Skv, block_q, block_kv):
    """JAX's dispatch: None for the single-tile path (B1/B2), iff the
    sequences fit their blocks; else the multi-tile path's checked blocks
    (B3-B5)."""
    if Sq <= block_q and Skv <= block_kv:
        return None
    return _blocks(Sq, block_q, "flash_attention q"), _blocks(Skv, block_kv, "flash_attention kv")


def _on_card(q, k, v, kv_mask):
    """True for CUDA tensors the kernels take, False for CPU tensors (the
    plain version); raises for any other device or input."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS or k.shape != (B, H, Skv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernels: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} (head_dim in "
                         f"{KERNEL_HEAD_DIMS})")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Skv):
        raise ValueError(f"kv_mask must be (B, Skv) = {(B, Skv)}, got {tuple(kv_mask.shape)}")
    return True


def _mask_bytes(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.bool).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _dims(q, k, causal, sm_scale):
    B, H, Sq, D = q.shape
    return (B, H, Sq, k.shape[2], D, int(q.dtype == torch.bfloat16), int(causal),
            float(sm_scale), _stream(q))


def _check_bwd_shapes(q, full, rows):
    """``full`` tensors have q's shape, ``rows`` its (B, H, Sq)."""
    if any(t.shape != q.shape for t in full) or any(r.shape != q.shape[:3] for r in rows):
        raise ValueError("flash_attention backward: do/o/lse/di shapes do not match q")


def _fwd_single(q, k, v, kv_mask, *, causal, sm_scale):
    """B1: ``(o, lse)``; the kernel on CUDA, the plain version on the CPU."""
    if not _on_card(q, k, v, kv_mask):
        return _fwd_single_plain(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)
    if q.dtype == torch.bfloat16 and k.shape[2] > SINGLE_MAX_KV:
        raise ValueError(f"flash_attention: the bf16 single-tile kernel takes at most "
                         f"{SINGLE_MAX_KV} keys, got {k.shape[2]} (pass smaller blocks)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = _mask_bytes(kv_mask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _lib("flash_single").flash_single_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse), *_dims(q, k, causal, sm_scale))
    _check(err, "flash_single_fwd")
    _fwd_single.launches += 1
    return o, lse


def _bwd_single(q, k, v, do, o, lse, kv_mask, *, causal, sm_scale):
    """B2: ``(dq, dk, dv)``; the kernel on CUDA, the plain version on the
    CPU."""
    if not _on_card(q, k, v, kv_mask):
        return _bwd_single_plain(q, k, v, do, o, lse, kv_mask, causal=causal,
                                 sm_scale=sm_scale)
    _check_bwd_shapes(q, (do, o), (lse,))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    o, lse = o.contiguous(), lse.to(torch.float32).contiguous()
    mask = _mask_bytes(kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the float32 kernel's dq partial sums; the bf16 kernel keeps dq in registers
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if q.dtype == torch.float32 and k.shape[2] > 64 else None)
    err = _lib("flash_single").flash_single_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(o), _ptr(lse), _ptr(mask), _ptr(dq),
        _ptr(dk), _ptr(dv), _ptr(dq_acc), *_dims(q, k, causal, sm_scale))
    _check(err, "flash_single_bwd")
    _bwd_single.launches += 1
    return dq, dk, dv


def _fwd_multi(q, k, v, kv_mask, *, causal, sm_scale, block_q, block_kv):
    """B3: ``(o, lse)``; the kernel on CUDA (64-row tiles), the plain version
    with the JAX blocks on the CPU."""
    if not _on_card(q, k, v, kv_mask):
        return _fwd_multi_plain(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                                block_q=block_q, block_kv=block_kv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = _mask_bytes(kv_mask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _lib("flash_multi").flash_multi_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse), *_dims(q, k, causal, sm_scale))
    _check(err, "flash_multi_fwd")
    _fwd_multi.launches += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, di, kv_mask):
    _check_bwd_shapes(q, (do,), (lse, di))
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.to(q.dtype).contiguous(),
            lse.to(torch.float32).contiguous(), di.to(torch.float32).contiguous(),
            _mask_bytes(kv_mask))


def _bwd_dkv(q, k, v, do, lse, di, kv_mask, *, causal, sm_scale):
    """B4: ``(dk, dv)``; the kernel on CUDA, the plain version on the CPU."""
    if not _on_card(q, k, v, kv_mask):
        return _bwd_dkv_plain(q, k, v, do, lse, di, kv_mask, causal=causal, sm_scale=sm_scale)
    q, k, v, do, lse, di, mask = _bwd_inputs(q, k, v, do, lse, di, kv_mask)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib("flash_multi").flash_multi_bwd_dkv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(di), _ptr(mask), _ptr(dk),
        _ptr(dv), *_dims(q, k, causal, sm_scale))
    _check(err, "flash_multi_bwd_dkv")
    _bwd_dkv.launches += 1
    return dk, dv


def _bwd_dq(q, k, v, do, lse, di, kv_mask, *, causal, sm_scale):
    """B5: ``dq``; the kernel on CUDA, the plain version on the CPU."""
    if not _on_card(q, k, v, kv_mask):
        return _bwd_dq_plain(q, k, v, do, lse, di, kv_mask, causal=causal, sm_scale=sm_scale)
    q, k, v, do, lse, di, mask = _bwd_inputs(q, k, v, do, lse, di, kv_mask)
    dq = torch.empty_like(q)
    err = _lib("flash_multi").flash_multi_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(di), _ptr(mask), _ptr(dq),
        *_dims(q, k, causal, sm_scale))
    _check(err, "flash_multi_bwd_dq")
    _bwd_dq.launches += 1
    return dq


KERNELS = {  # kernel name -> wrapper; each wrapper counts its launches
    "flash_single_fwd": _fwd_single,
    "flash_single_bwd": _bwd_single,
    "flash_multi_fwd": _fwd_multi,
    "flash_multi_bwd_dkv": _bwd_dkv,
    "flash_multi_bwd_dq": _bwd_dq,
}


def reset_launch_counts():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FlashAttentionFn(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom VJP: saves q, k, v, the mask,
    o and lse; the forward is B1 or B3 and the backward B2 or B4 + B5, by
    the same dispatch. No forward-mode rule."""

    @staticmethod
    def forward(q, k, v, kv_mask, causal, sm_scale, block_q, block_kv):
        blocks = _multi_tile_blocks(q.shape[2], k.shape[2], block_q, block_kv)
        if blocks is None:
            return _fwd_single(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)
        return _fwd_multi(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                          block_q=blocks[0], block_kv=blocks[1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kv_mask, causal, sm_scale, block_q, block_kv = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.block_q, ctx.block_kv = block_q, block_kv
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        if _multi_tile_blocks(q.shape[2], k.shape[2], ctx.block_q, ctx.block_kv) is None:
            dq, dk, dv = _bwd_single(q, k, v, do, o, lse, kv_mask, **kw)
        else:
            di = (_acc(o) * _acc(do)).sum(-1)
            dk, dv = _bwd_dkv(q, k, v, do, lse, di, kv_mask, **kw)
            dq = _bwd_dq(q, k, v, do, lse, di, kv_mask, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_mask=None, *, causal=False, sm_scale=None, block_q=None,
                    block_kv=None):
    """``softmax(q k^T * sm_scale) v`` through the flash kernels.

    q, k, v: ``(batch, heads, seq, head_dim)``, float32 or bfloat16 on CUDA
    (any float dtype on the CPU). ``kv_mask``: optional ``(batch, kv_seq)``
    bool, True where keys are valid; query rows are not masked. ``causal``:
    lower-triangular masking. ``sm_scale`` defaults to ``1/sqrt(head_dim)``.
    ``block_q`` / ``block_kv``: JAX's tile sizes, default ``min(512, seq)``;
    sequences within them take the single-tile kernels (B1/B2), others must
    divide by them and take the multi-tile kernels (B3-B5). Reverse-mode
    differentiable only.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if block_q is None:
        block_q = min(DEFAULT_BLOCK, q.shape[2])
    if block_kv is None:
        block_kv = min(DEFAULT_BLOCK, k.shape[2])
    o, _ = FlashAttentionFn.apply(q, k, v, kv_mask, bool(causal), float(sm_scale),
                                  int(block_q), int(block_kv))
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
