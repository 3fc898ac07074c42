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

Dropout draws its masks from a ``torch.Generator`` seeded with
``rngs["dropout"]`` (``utils.seeded_generator``), so a forward repeated
with the same seed draws the same masks. ``remat`` / ``remat_policy`` and ``make_pipelined_transformer`` are
not ported yet.
"""

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.init import lecun_normal_, normal_
from betty_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from betty_tpu_torch.utils import seeded_generator


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
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
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
        if self.use_flash:
            o = flash_attention(q, k, v, kv_mask, causal=self.causal, block_q=self.block_q,
                                block_kv=self.block_kv)
        else:
            o = reference_attention(q, k, v, kv_mask, causal=self.causal,
                                    dropout_rate=self.dropout, generator=generator)
        return self.out(o)


class EncoderBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4, dropout=0.1, use_flash=False, device=None,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.attn = FlashSelfAttention(heads, dim, use_flash=use_flash, dropout=dropout,
                                       device=device, generator=generator)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.fc1 = _linear(dim, dim * mlp_ratio, device, generator)
        self.fc2 = _linear(dim * mlp_ratio, dim, device, generator)

    def forward(self, x, kv_mask=None, generator=None):
        y = self.attn(self.ln1(x), kv_mask=kv_mask, generator=generator)
        x = x + _dropout(y, self.dropout, generator)
        y = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + _dropout(y, self.dropout, generator)


class TransformerClassifier(nn.Module):
    def __init__(self, vocab_size=50265, max_len=128, dim=256, depth=4, heads=8,
                 num_classes=2, dropout=0.1, pad_id=1, use_flash=False, remat=False,
                 remat_policy=None, device=None, seed=0):
        super().__init__()
        if remat or remat_policy is not None:
            raise NotImplementedError("TransformerClassifier: remat is not ported yet")
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.dropout = dropout
        self.pad_id = pad_id
        self.embed = nn.Embedding(vocab_size, dim, device=device)
        lecun_normal_(self.embed.weight, fan_in=dim, generator=gen)
        self.pos_embedding = nn.Parameter(torch.empty(1, max_len, dim, device=device))
        normal_(self.pos_embedding, 0.02, generator=gen)
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, dropout=dropout, use_flash=use_flash, device=device,
                         generator=gen)
            for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.pool = _linear(dim, dim, device, gen)
        self.head = _linear(dim, num_classes, device, gen)

    def forward(self, input_ids, train: bool = True, rngs=None):
        L = input_ids.shape[1]
        pad_mask = input_ids != self.pad_id  # (B, L)
        x = self.embed(input_ids) + self.pos_embedding[:, :L]
        generator = None
        if train and self.dropout > 0.0:
            if not rngs or "dropout" not in rngs:
                raise ValueError("TransformerClassifier: train-mode dropout needs "
                                 "rngs={'dropout': seed}")
            generator = seeded_generator(rngs["dropout"], x.device)
        x = _dropout(x, self.dropout, generator)
        for block in self.blocks:
            x = block(x, kv_mask=pad_mask, generator=generator)
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
