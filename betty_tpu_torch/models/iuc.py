"""The image captioner of the 3-level NAS-augmented image-captioning
program (IUC): an architecture-mixed image encoder and a causal
transformer decoder with cross-attention to the encoded image.

Port of ``DecoderBlock`` and ``Captioner`` of
``examples/nas_augmented_image_captioning_3_level/main.py``, with flax's
numerics:

* pre-LN blocks, LayerNorm eps 1e-6; the MLP is GELU with the tanh
  approximation;
* attention as ``flax.linen.dot_product_attention``: the query divided by
  ``sqrt(Dh)`` before the product, ``finfo(dtype).min`` at masked logits,
  the softmax in the logits' dtype; q/k/v kernels ``(d, H, Dh)`` and the
  output kernel ``(H, Dh, d)``, all with biases
  (``models/transformer.py``'s ``_HeadProj``/``_OutProj``). Self-attention
  under a causal mask, cross-attention to ``mem_tokens`` memory rows
  unmasked. This attention has no Pallas kernel in the JAX package (XLA
  computes it), so it stays plain PyTorch products here;
* ``encode`` mixes two branches by ``softmax(alphas)``: a GELU MLP and a
  fixed chaotic map ``sin(feats @ (4 proj))``, each through its own
  LayerNorm.

``proj`` is a constant of the model, not a parameter: JAX draws it from
``PRNGKey(1234)`` at trace time, the port from a host ``torch.Generator``
seeded with 1234 (the same on every device), and keeps it as a
non-persistent buffer (not part of the problem's state;
``module.from_torch`` leaves such buffers to the module).
``convert.from_flax_captioner`` carries JAX's weights, and JAX's
projection when it is given, over.

Port parameter names: ``enc_deep.{0,1}``, ``enc_norm_a``, ``enc_norm_b``,
``tok_emb.weight``, ``pos_emb`` ``(1, max_len, d)``,
``blocks.i.{ln1,self_attn,ln2,cross_attn,ln3,fc1,fc2}``, ``out_ln``,
``out_proj``.
"""

import math

import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.init import normal_
from betty_tpu_torch.models.mlp import dense
from betty_tpu_torch.models.transformer import _HeadProj, _OutProj


def gelu(x):
    """flax ``nn.gelu`` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=dim)``
    (``SelfAttention`` when ``kv is x``)."""

    def __init__(self, dim, heads, device=None, generator=None):
        super().__init__()
        head_dim = dim // heads
        for name in ("query", "key", "value"):
            setattr(self, name, _HeadProj(dim, heads, head_dim, device, generator))
        self.out = _OutProj(heads, head_dim, dim, device, generator)

    def forward(self, x, kv, mask=None):
        """``mask``: bool, broadcast to (B, H, Lq, Lk), True = attend."""
        q, k, v = self.query(x), self.key(kv), self.value(kv)
        q = q / math.sqrt(q.shape[-1])
        logits = q @ k.transpose(-1, -2)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        return self.out(torch.softmax(logits, dim=-1) @ v)


class DecoderBlock(nn.Module):
    def __init__(self, dim, heads, device=None, generator=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.self_attn = Attention(dim, heads, device, generator)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.cross_attn = Attention(dim, heads, device, generator)
        self.ln3 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.fc1 = dense(dim, dim * 4, device, generator)
        self.fc2 = dense(dim * 4, dim, device, generator)

    def forward(self, x, memory, causal):
        y = self.ln1(x)
        x = x + self.self_attn(y, y, causal)
        x = x + self.cross_attn(self.ln2(x), memory)
        return x + self.fc2(gelu(self.fc1(self.ln3(x))))


class Captioner(nn.Module):
    """Architecture-mixed encoder and teacher-forced decoder; ``forward``
    gives the logits of positions 1..L from ``caption_in`` (B, L)."""

    def __init__(self, vocab, feat_dim, dim=64, depth=2, heads=4, max_len=16, mem_tokens=4,
                 device=None, seed=0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.dim, self.mem_tokens = dim, mem_tokens
        self.enc_deep = nn.ModuleList([dense(feat_dim, dim * 2, device, gen),
                                       dense(dim * 2, mem_tokens * dim, device, gen)])
        self.enc_norm_a = nn.LayerNorm(mem_tokens * dim, eps=1e-6, device=device)
        self.enc_norm_b = nn.LayerNorm(mem_tokens * dim, eps=1e-6, device=device)
        self.tok_emb = nn.Embedding(vocab, dim, device=device)
        normal_(self.tok_emb.weight, 1.0 / math.sqrt(dim), gen)
        self.pos_emb = nn.Parameter(normal_(torch.empty(1, max_len, dim, device=device), 0.02,
                                            gen))
        self.blocks = nn.ModuleList(DecoderBlock(dim, heads, device, gen) for _ in range(depth))
        self.out_ln = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.out_proj = dense(dim, vocab, device, gen)
        # the chaotic branch's frozen projection: a constant of the model,
        # drawn on the host so that every device holds the same one
        proj = torch.randn(feat_dim, mem_tokens * dim,
                           generator=torch.Generator().manual_seed(1234))
        self.register_buffer("proj", proj if device is None else proj.to(device),
                             persistent=False)

    def encode(self, feats, alphas):
        w = torch.softmax(alphas, dim=0)
        deep = self.enc_deep[1](gelu(self.enc_deep[0](feats)))
        wide = torch.sin(feats @ (4.0 * self.proj.to(feats.dtype)))
        mixed = w[0] * self.enc_norm_a(deep) + w[1] * self.enc_norm_b(wide)
        return mixed.reshape(feats.shape[0], self.mem_tokens, self.dim)

    def forward(self, feats, alphas, caption_in, train: bool = True, rngs=None):
        memory = self.encode(feats, alphas)
        L = caption_in.shape[1]
        x = F.embedding(caption_in, self.tok_emb.weight) + self.pos_emb[:, :L]
        causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        for blk in self.blocks:
            x = blk(x, memory, causal)
        return self.out_proj(self.out_ln(x))
