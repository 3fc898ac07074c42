"""Transformer encoder classifier (RoBERTa-style) for SAMA data reweighting.

Counterpart of ``betty_tpu/models/transformer.py``: a pre-LN encoder with
the same parameter shapes (q/k/v kernels ``(d, H, Dh)`` with bias
``(H, Dh)``, out kernel ``(H, Dh, d)``), so weights move across with
``betty_tpu_torch.convert``. Numerics follow flax's defaults: LayerNorm
epsilon 1e-6 and the tanh approximation of GELU.

The q/k/v projections emit the kernels' ``(B, H, L, Dh)`` layout straight
from their einsum. ``use_flash=True`` routes attention through the flash
CUDA kernels (``ops/flash_attention.py``: single-tile up to the blocks,
512 by default, multi-tile beyond) and has no attention-probability
dropout, as in the JAX package's flash path;
``use_flash=False`` uses ``reference_attention`` on the same parameters
with flax ``MultiHeadDotProductAttention``'s attention dropout (one keep
mask over (query, key), broadcast across batch and heads, 1/keep scaling).

Dropout draws its masks from ``torch.Generator``s (``utils.seeded_generator``):
the embedding dropout from one seeded with ``rngs["dropout"]``, block i's
from its own, seeded with ``fold_in(rngs["dropout"], i + 1)`` and made
inside the block. A forward repeated with the same seed draws the same
masks, and so does a block recomputed in the backward. Under a
data-parallel mesh each rank draws the mask of the global batch and keeps
its rows (``parallel.local_rows``: rows ``rank::world``, the rows its
examples hold under ``shard_loader`` with ``shuffle=False``), so a
data-parallel run draws the one-process run's masks at any dropout rate.

``remat=True`` recomputes each encoder block in the backward
(``torch.utils.checkpoint``, non-reentrant), the counterpart of JAX's
``nn.remat`` per block, with ``remat_policy``:

* ``None`` without flash: the whole block is recomputed (blanket).
* ``None`` with flash: selective. The flash kernel's residuals (q, k, v, o,
  lse) are kept and LayerNorm, the projections and the MLP are recomputed,
  so the backward never replays B1/B3 (JAX's
  ``flash_attention.remat_policy()``). Route: the block is split by hand
  into two checkpointed segments around the attention call (LayerNorm and
  the q/k/v projections; the output projection, residuals, LayerNorm and
  MLP), and the flash call between them keeps its own residuals. A flash
  kernel launched through ctypes inside an ``autograd.Function`` is
  invisible to a selective-checkpoint policy, so naming it there is not
  an option without registering it as a custom op.
* ``"minimal"``: the whole block, flash included, is recomputed: the
  backward replays B1 or B3 once per block.
* ``"dots"``: every matmul output (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
  is kept and the elementwise math recomputed
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``, JAX's
  ``checkpoint_dots``); with flash on the split segments, so the flash
  residuals are kept too (JAX's ``save_from_both_policies``). Without
  flash at S512 this keeps the (B, H, S, S) scores of every layer: it does
  not fit where the blanket policy does.

Inside a ``torch.func`` transform (the CG and Neumann HVPs with
``hvp_mode="jvp"``) the blocks keep their activations: ``torch.func``
does not take the saved-tensor hooks that ``torch.utils.checkpoint``
installs. Anything else raises ``ValueError``, as JAX's model does. Since each
block's dropout generator is made from its seed inside the recomputed
function, remat on and off draw the same masks and compute the same
numbers (inside a compiled block the recompute takes its own generators
of the reseeded pool). ``make_pipelined_transformer`` is not ported yet.
"""

import functools

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from betty_tpu_torch.models.init import lecun_normal_, normal_
from betty_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from betty_tpu_torch.parallel import local_rows
from betty_tpu_torch.utils import fold_in, seeded_generator

REMAT_POLICIES = (None, "minimal", "dots")


def _linear(d_in, d_out, device, generator):
    layer = nn.Linear(d_in, d_out, device=device)
    lecun_normal_(layer.weight, fan_in=d_in, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _dropout(x, rate, generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate). No-op without a generator (eval) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = local_rows(x.shape, lambda shape: torch.rand(shape, generator=generator,
                                                        device=x.device)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class _HeadProj(nn.Module):
    """q/k/v projection (B, L, d) -> (B, H, L, Dh); kernel (d, H, Dh),
    bias (H, Dh)."""

    def __init__(self, dim, heads, head_dim, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim, heads, head_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim, device=device))
        lecun_normal_(self.kernel, fan_in=dim, generator=generator)

    def forward(self, x):
        return torch.einsum("bld,dhk->bhlk", x, self.kernel) + self.bias[None, :, None, :]


class _OutProj(nn.Module):
    """Output projection (B, H, L, Dh) -> (B, L, d); kernel (H, Dh, d),
    bias (d,)."""

    def __init__(self, heads, head_dim, features, device=None, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(heads, head_dim, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        lecun_normal_(self.kernel, fan_in=heads * head_dim, generator=generator)

    def forward(self, o):
        return torch.einsum("bhlk,hkd->bld", o, self.kernel) + self.bias


class FlashSelfAttention(nn.Module):
    """Self-attention with ``query``/``key``/``value``/``out`` projections.
    ``kv_mask`` is the (B, L) key-padding mask (True = attend); query rows
    are not masked (every model here masks them downstream). ``block_q`` /
    ``block_kv``: the flash path's tile sizes (None: ``flash_attention``'s
    defaults), as the JAX module's fields."""

    def __init__(self, num_heads, qkv_features, causal=False, use_flash=True, dropout=0.0,
                 block_q=None, block_kv=None, device=None, generator=None):
        super().__init__()
        head_dim = qkv_features // num_heads
        self.causal = causal
        self.use_flash = use_flash
        self.block_q, self.block_kv = block_q, block_kv
        self.dropout = dropout
        for name in ("query", "key", "value"):
            setattr(self, name, _HeadProj(qkv_features, num_heads, head_dim, device, generator))
        self.out = _OutProj(num_heads, head_dim, qkv_features, device, generator)

    def forward(self, x, kv_mask=None, generator=None):
        """``generator``: the dropout stream in train mode, None in eval."""
        q, k, v = self.query(x), self.key(x), self.value(x)
        return self.out(self.attend(q, k, v, kv_mask, generator))

    def attend(self, q, k, v, kv_mask=None, generator=None):
        """The attention of projected ``(B, H, L, Dh)`` q, k, v, before the
        output projection."""
        if self.use_flash:
            return flash_attention(q, k, v, kv_mask, causal=self.causal, block_q=self.block_q,
                                   block_kv=self.block_kv)
        return reference_attention(q, k, v, kv_mask, causal=self.causal,
                                   dropout_rate=self.dropout, generator=generator)


_MATMULS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
            torch.ops.aten.baddbmm)


def _dots_policy(ctx, func, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep matmul outputs."""
    if func._overloadpacket in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, dots, *args):
    """``fn(*args)`` recomputed in the backward; with ``dots`` its matmul
    outputs are kept. The default generators' states are not saved: the
    blocks draw from their own seeded generators."""
    kw = {}
    if dots:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _in_functorch() -> bool:
    """True inside a ``torch.func`` transform (the CG and Neumann HVPs with
    ``hvp_mode="jvp"``), whose saved-tensor hooks ``torch.utils.checkpoint``
    cannot install: the blocks keep their activations there."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _generator(seed, device):
    return None if seed is None else seeded_generator(seed, device)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block. ``remat``: None (keep every activation),
    ``"blanket"`` (recompute the block), ``"split"`` (recompute the two
    segments around the attention call, whose residuals are kept); ``dots``
    keeps the matmul outputs of what is recomputed."""

    def __init__(self, dim, heads, mlp_ratio=4, dropout=0.1, use_flash=False, device=None,
                 generator=None, remat=None, dots=False):
        super().__init__()
        self.dropout = dropout
        self.remat, self.dots = remat, dots
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = FlashSelfAttention(heads, dim, use_flash=use_flash, dropout=dropout,
                                       device=device, generator=generator)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.fc1 = _linear(dim, dim * mlp_ratio, device, generator)
        self.fc2 = _linear(dim * mlp_ratio, dim, device, generator)

    def forward(self, x, kv_mask=None, seed=None, o=None, segment=None):
        """``seed``: the block's dropout seed in train mode, None in eval.
        ``segment`` ("block", "qkv" or "tail", with ``o`` the attention's
        output) runs that part alone: what a recompute calls."""
        if segment == "block":
            return self._block(x, kv_mask, seed)
        if segment == "qkv":
            return self._qkv(x)
        if segment == "tail":
            return self._tail(x, o, seed)
        if self.remat is None or not torch.is_grad_enabled() or _in_functorch():
            return self._block(x, kv_mask, seed)
        if self.remat == "blanket":
            return self._recomputed("block", x, kv_mask, seed)
        q, k, v = self._recomputed("qkv", x)
        o = self.attn.attend(q, k, v, kv_mask)
        return self._recomputed("tail", x, seed=seed, o=o)

    def _recomputed(self, segment, x, kv_mask=None, seed=None, o=None):
        """``segment`` of this block, recomputed in the backward. The
        block's parameters are inputs of the recomputed function, bound by
        ``functional_call``: the backward runs after the caller's own
        ``functional_call`` (``module.from_torch``) has put the module's
        parameters back, so it must bind the tensors of the forward again."""
        def run(params, x, kv_mask, o):
            return torch.func.functional_call(
                self, params, (x,), {"kv_mask": kv_mask, "seed": seed, "o": o,
                                     "segment": segment})

        return _checkpoint(run, self.dots, dict(self.named_parameters()), x, kv_mask, o)

    def _qkv(self, x):
        y = self.ln1(x)
        return self.attn.query(y), self.attn.key(y), self.attn.value(y)

    def _block(self, x, kv_mask, seed):
        generator = _generator(seed, x.device)
        o = self.attn.attend(*self._qkv(x), kv_mask, generator)
        return self._residuals(x, o, generator)

    def _tail(self, x, o, seed):
        return self._residuals(x, o, _generator(seed, x.device))

    def _residuals(self, x, o, generator):
        """Output projection, both residual branches and the MLP; the
        attention's own dropout (plain path) drew from ``generator`` first."""
        x = x + _dropout(self.attn.out(o), self.dropout, generator)
        y = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + _dropout(y, self.dropout, generator)


class TransformerClassifier(nn.Module):
    def __init__(self, vocab_size=50265, max_len=128, dim=256, depth=4, heads=8,
                 num_classes=2, dropout=0.1, pad_id=1, use_flash=False, remat=False,
                 remat_policy=None, device=None, seed=0):
        super().__init__()
        block_remat = None
        if remat:
            if remat_policy not in REMAT_POLICIES:
                raise ValueError(
                    f"remat_policy={remat_policy!r}: expected None (blanket), 'minimal' "
                    "(blanket even for flash residuals) or 'dots' (save matmul outputs)")
            block_remat = "split" if use_flash and remat_policy != "minimal" else "blanket"
        self.remat, self.remat_policy = remat, remat_policy
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.dropout = dropout
        self.pad_id = pad_id
        self.embed = nn.Embedding(vocab_size, dim, device=device)
        lecun_normal_(self.embed.weight, fan_in=dim, generator=gen)
        self.pos_embedding = nn.Parameter(torch.empty(1, max_len, dim, device=device))
        normal_(self.pos_embedding, 0.02, generator=gen)
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, dropout=dropout, use_flash=use_flash, device=device,
                         generator=gen, remat=block_remat, dots=remat_policy == "dots")
            for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.pool = _linear(dim, dim, device, gen)
        self.head = _linear(dim, num_classes, device, gen)

    def forward(self, input_ids, train: bool = True, rngs=None):
        L = input_ids.shape[1]
        pad_mask = input_ids != self.pad_id  # (B, L)
        x = self.embed(input_ids) + self.pos_embedding[:, :L]
        seed = None
        if train and self.dropout > 0.0:
            if not rngs or "dropout" not in rngs:
                raise ValueError("TransformerClassifier: train-mode dropout needs "
                                 "rngs={'dropout': seed}")
            seed = rngs["dropout"]
        x = _dropout(x, self.dropout, _generator(seed, x.device))
        for i, block in enumerate(self.blocks):
            x = block(x, kv_mask=pad_mask, seed=None if seed is None else fold_in(seed, i + 1))
        x = self.ln_f(x)
        # masked mean pool
        denom = torch.clamp(pad_mask.sum(dim=1, keepdim=True), min=1)
        pooled = (x * pad_mask[..., None]).sum(dim=1) / denom
        pooled = torch.tanh(self.pool(pooled))
        return self.head(pooled)


def roberta_large_config(num_classes: int = 2, max_len: int = 128, use_flash: bool = False,
                         remat: bool = False, dropout: float = 0.1, remat_policy=None,
                         device=None, seed=0):
    """The north-star scale (about 355M parameters)."""
    return TransformerClassifier(
        vocab_size=50265, max_len=max_len, dim=1024, depth=24, heads=16,
        num_classes=num_classes, use_flash=use_flash, remat=remat, dropout=dropout,
        remat_policy=remat_policy, device=device, seed=seed)
