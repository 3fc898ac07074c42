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
of the reseeded pool).

Under tensor parallelism (a mesh with a model axis bound, ``strategy="tp"``)
a block computes as Megatron's (arXiv:1909.08053): the attention on its
rank's H/m heads (the q/k/v kernels' and the out kernel's head chunks; the
flash kernels run unchanged on fewer heads), the output projection
row-parallel and summed over the model group (*g*), ``fc1`` column-parallel
with its bias, GELU local, ``fc2`` row-parallel and summed; the ``out`` and
``fc2`` biases are added once, after the sums. The LayerNorm outputs enter
the split computation through *f* (``parallel.copy_to_model``: its backward
sums the ranks' cotangents). ``TransformerClassifier.tensor_parallel_dims``
names those leaves and dims; each arrives as its rank's chunk or whole (a
layout that does not shard it there: then *f* and this rank's chunk), and a
group whose main weight (the query kernel, ``fc1``) arrives whole on
several ranks runs as without tp. Every rank of a model group draws the
same dropout stream, so the replicated activations get the unsharded run's
masks.

``make_pipelined_transformer`` (``betty_tpu/models/transformer.py:241-371``)
is the same encoder with its blocks' parameters STACKED (a leading depth
dim: ``blocks.attn.query.kernel`` is ``(depth, d, H, Dh)``) beside
``embed.tok``/``embed.pos`` and ``head.*``, dropout-free, as a
``FunctionalModule``. Its stack runs one block after another
(``parallel/pipeline.py::sequential``), as a GPipe pipeline over the bound
mesh's ``pp`` axis (``gpipe``; beside a ``mdl`` axis each stage computes
the tensor-parallel block above over ``mdl``: ``_heads_qkv``,
``_heads_out`` and ``_mlp`` serve both encoders), or sequence-parallel
over its ``sp`` axis (``seq_axis="sp"``: each rank's ``L/S`` positions
through LayerNorm and the MLP, attention on its queries against the keys
and values gathered whole; beside a ``mdl`` axis on its heads and MLP
columns too, Megatron-SP).
"""

import functools

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from betty_tpu_torch.models.init import lecun_normal_, normal_
from betty_tpu_torch.ops.flash_attention import flash_attention, reference_attention
from betty_tpu_torch.parallel import copy_to_model, local_rows, reduce_from_model
from betty_tpu_torch.parallel.mesh import MODEL_AXES, Cut, axis_mesh, tp_mesh
from betty_tpu_torch.utils import fold_in, seeded_generator

REMAT_POLICIES = (None, "minimal", "dots")


def _linear(d_in, d_out, device, generator):
    layer = nn.Linear(d_in, d_out, device=device)
    lecun_normal_(layer.weight, fan_in=d_in, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _tp_part(x, dim, full, mesh):
    """This model rank's chunk along ``dim`` of a parameter ``full`` long
    there, which arrives as that chunk or whole (then through *f*, whose
    backward sums the ranks' cotangents of the whole tensor)."""
    m = mesh.model_size
    if x.shape[dim] * m == full:
        return x
    if x.shape[dim] != full:
        raise ValueError(f"tensor parallelism: a parameter of shape {tuple(x.shape)} is neither "
                         f"whole ({full} along dim {dim}) nor a 1/{m} chunk of it")
    return copy_to_model(x, mesh).chunk(m, dim)[mesh.model_index]


def _tp_mesh(local: int, full: int):
    """The bound model-axis mesh if a group whose main weight holds
    ``local`` of ``full`` rows computes split over it, else None."""
    mesh = tp_mesh()
    if mesh is None or (mesh.model_size > 1 and local == full):
        return None
    return mesh


def _dropout(x, rate, generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate). No-op without a generator (eval) or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep = local_rows(x.shape, lambda shape: torch.rand(shape, generator=generator,
                                                        device=x.device)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _heads_qkv(x, kernels, biases, heads, tp=None):
    """q, k, v ``(B, H', L, Dh)`` of ``x`` (B, L, d) with the kernels
    ``(d, H, Dh)`` and biases ``(H, Dh)``: every head without ``tp``; with
    it (a model-axis mesh) this rank's H/m heads, ``x`` through *f*, each
    kernel and bias taken as its head chunk or cut from the whole
    (``_tp_part``; three whole biases through one *f*)."""
    if tp is not None:
        x = copy_to_model(x, tp)
        if all(b.shape[0] == heads for b in biases) and tp.model_size > 1:
            # whole biases (the default layout shards them on Dh and they
            # are gathered): one f for the three, then this rank's heads
            biases = copy_to_model(torch.stack(biases), tp).chunk(
                tp.model_size, 1)[tp.model_index].unbind(0)
        else:
            biases = [_tp_part(b, 0, heads, tp) for b in biases]
        kernels = [_tp_part(k, 1, heads, tp) for k in kernels]
    return tuple(torch.einsum("bld,dhk->bhlk", x, k) + b[None, :, None, :]
                 for k, b in zip(kernels, biases))


def _heads_out(o, kernel, bias, heads, tp=None):
    """The output projection (B, H', L, Dh) -> (B, L, d), kernel ``(H, Dh,
    d)``; with ``tp`` row parallel on this rank's heads, the partial
    products summed over the model group (*g*) before the bias."""
    if tp is None:
        return torch.einsum("bhlk,hkd->bld", o, kernel) + bias
    kernel = _tp_part(kernel, 0, heads, tp)
    return reduce_from_model(torch.einsum("bhlk,hkd->bld", o, kernel), tp) + bias


def _mlp(y, w1, b1, w2, b2, hidden, tp=None):
    """``fc2(gelu(fc1(y)))`` on ``nn.Linear`` weights; with ``tp`` ``fc1``
    column parallel (this rank's ``hidden/m`` rows of ``w1`` and ``b1``, y
    through *f*), GELU local, ``fc2`` row parallel and summed over the
    model group (*g*), its bias after the sum."""
    if tp is None:
        return F.linear(F.gelu(F.linear(y, w1, b1), approximate="tanh"), w2, b2)
    w1, b1 = _tp_part(w1, 0, hidden, tp), _tp_part(b1, 0, hidden, tp)
    w2 = _tp_part(w2, 1, hidden, tp)
    h = F.gelu(F.linear(copy_to_model(y, tp), w1, b1), approximate="tanh")
    return reduce_from_model(F.linear(h, w2), tp) + b2


class _HeadProj(nn.Module):
    """q/k/v projection (B, L, d) -> (B, H, L, Dh); kernel (d, H, Dh),
    bias (H, Dh)."""

    def __init__(self, dim, heads, head_dim, device=None, generator=None):
        super().__init__()
        self.heads = heads
        self.kernel = nn.Parameter(torch.empty(dim, heads, head_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim, device=device))
        lecun_normal_(self.kernel, fan_in=dim, generator=generator)

    def forward(self, x):
        return _heads_qkv(x, [self.kernel], [self.bias], self.heads)[0]


class _OutProj(nn.Module):
    """Output projection (B, H, L, Dh) -> (B, L, d); kernel (H, Dh, d),
    bias (d,)."""

    def __init__(self, heads, head_dim, features, device=None, generator=None):
        super().__init__()
        self.heads = heads
        self.kernel = nn.Parameter(torch.empty(heads, head_dim, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        lecun_normal_(self.kernel, fan_in=heads * head_dim, generator=generator)

    def forward(self, o, tp=None):
        """``tp``: the model-axis mesh whose rank's heads ``o`` holds (row
        parallel), or None."""
        return _heads_out(o, self.kernel, self.bias, self.heads, tp)


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
        self.num_heads = num_heads
        self.causal = causal
        self.use_flash = use_flash
        self.block_q, self.block_kv = block_q, block_kv
        self.dropout = dropout
        for name in ("query", "key", "value"):
            setattr(self, name, _HeadProj(qkv_features, num_heads, head_dim, device, generator))
        self.out = _OutProj(num_heads, head_dim, qkv_features, device, generator)

    def forward(self, x, kv_mask=None, generator=None):
        """``generator``: the dropout stream in train mode, None in eval."""
        q, k, v = self.project(x)
        return self.out(self.attend(q, k, v, kv_mask, generator), self.tp_mesh())

    def tp_mesh(self):
        """The model-axis mesh the heads are split over, or None."""
        return _tp_mesh(self.query.kernel.shape[1], self.num_heads)

    def project(self, x):
        """q, k, v of ``x`` on this rank's heads (all of them without tp)."""
        projs = (self.query, self.key, self.value)
        return _heads_qkv(x, [p.kernel for p in projs], [p.bias for p in projs],
                          self.num_heads, self.tp_mesh())

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
        self.hidden = dim * mlp_ratio
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
        return self.attn.project(self.ln1(x))

    def _block(self, x, kv_mask, seed):
        generator = _generator(seed, x.device)
        o = self.attn.attend(*self._qkv(x), kv_mask, generator)
        return self._residuals(x, o, generator)

    def _tail(self, x, o, seed):
        return self._residuals(x, o, _generator(seed, x.device))

    def _residuals(self, x, o, generator):
        """Output projection, both residual branches and the MLP; the
        attention's own dropout (plain path) drew from ``generator`` first."""
        x = x + _dropout(self.attn.out(o, self.attn.tp_mesh()), self.dropout, generator)
        y = _mlp(self.ln2(x), self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias,
                 self.hidden, _tp_mesh(self.fc1.weight.shape[0], self.hidden))
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
        # on the meta device (the shapes alone, for layouts) nothing is drawn
        gen = None if device is not None and torch.device(device).type == "meta" else \
            torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
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

    def tensor_parallel_dims(self):
        """The leaves the blocks compute on as tp shards, and the dim of
        each (``module.FunctionalModule.local_dim``): the q/k/v kernels' and
        biases' heads, the out kernel's heads, ``fc1``'s rows and bias and
        ``fc2``'s columns. A layout that shards them elsewhere (the default
        rules put the q/k/v biases on Dh) has them gathered."""
        out = {}
        for i in range(len(self.blocks)):
            pre = f"blocks.{i}."
            for name in ("query", "key", "value"):
                out[f"{pre}attn.{name}.kernel"] = 1
                out[f"{pre}attn.{name}.bias"] = 0
            out.update({f"{pre}attn.out.kernel": 0, f"{pre}fc1.weight": 0,
                        f"{pre}fc1.bias": 0, f"{pre}fc2.weight": 1})
        return out

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


# ---------------------------------------------------------------------------
# the pipelined (stage-stacked) transformer
# ---------------------------------------------------------------------------

# a block's leaves by the port's names, with their shapes at width d, H heads
def _block_shapes(dim, heads, mlp_ratio=4):
    dh, hid = dim // heads, dim * mlp_ratio
    out = {"ln1.weight": (dim,), "ln1.bias": (dim,)}
    for name in ("query", "key", "value"):
        out[f"attn.{name}.kernel"] = (dim, heads, dh)
        out[f"attn.{name}.bias"] = (heads, dh)
    out.update({"attn.out.kernel": (heads, dh, dim), "attn.out.bias": (dim,),
                "ln2.weight": (dim,), "ln2.bias": (dim,), "fc1.weight": (hid, dim),
                "fc1.bias": (hid,), "fc2.weight": (dim, hid), "fc2.bias": (dim,)})
    return out


def _init_block(dim, heads, seed, device, dtype):
    """One block's parameters, flax's default initializers (lecun normal
    kernels, zero biases, unit LayerNorm scales), drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p = {}
    for name, shape in _block_shapes(dim, heads).items():
        t = torch.empty(shape, device=device, dtype=dtype)
        if name.endswith(("kernel", "fc1.weight", "fc2.weight")):
            fan_in = shape[0] * shape[1] if name == "attn.out.kernel" else (
                shape[1] if name.startswith("fc") else shape[0])
            lecun_normal_(t, fan_in=fan_in, generator=gen)
        elif name.startswith("ln") and name.endswith("weight"):
            t.fill_(1.0)
        else:
            t.zero_()
        p[name] = t
    return p


_QKV = ("query", "key", "value")

# the dim of each stacked block leaf that tensor parallelism cuts (heads,
# MLP rows or columns) after the leading depth dim
_PIPELINED_TP_DIMS = {**{f"attn.{n}.kernel": 2 for n in _QKV},
                      **{f"attn.{n}.bias": 1 for n in _QKV},
                      "attn.out.kernel": 1, "fc1.weight": 1, "fc1.bias": 1, "fc2.weight": 2}

# The JAX package's ``_COMPOSED_RULES`` (tests/test_composed.py:208-220) on
# the port's names: the stacked attention kernels cut on the stage dim over
# ``pp`` and on heads over ``mdl``, the stacked MLP column- then
# row-parallel (``nn.Linear`` weights: the transposes of flax's
# ``Dense_0``/``Dense_1`` kernels), every other stacked leaf on ``pp``
# alone, the rest replicated
COMPOSED_SHARD_RULES = (
    (r"^blocks\.attn\.(query|key|value)\.kernel$", ("pp", None, "mdl", None)),
    (r"^blocks\.attn\.out\.kernel$", ("pp", "mdl", None, None)),
    (r"^blocks\.fc1\.weight$", ("pp", "mdl", None)),
    (r"^blocks\.fc2\.weight$", ("pp", None, "mdl")),
    (r"^blocks", ("pp",)),
    (r".*", ()),
)
# Megatron-SP on ``(dp, mdl, sp)`` (arXiv:2205.05198 §4.2): the same cuts
# over ``mdl`` with the stage dim left whole (tests/test_composed.py's
# ``_COMPOSED_RULES`` with "pp" replaced by None), every other leaf whole
SP_COMPOSED_SHARD_RULES = (
    (r"^blocks\.attn\.(query|key|value)\.kernel$", (None, None, "mdl", None)),
    (r"^blocks\.attn\.out\.kernel$", (None, "mdl", None, None)),
    (r"^blocks\.fc1\.weight$", (None, "mdl", None)),
    (r"^blocks\.fc2\.weight$", (None, None, "mdl")),
    (r".*", ()),
)
PP_SHARD_RULES = ((r"^blocks", ("pp",)),)


def pipelined_shard_rules(mesh=None):
    """``Config.shard_rules`` for ``make_pipelined_transformer`` under
    ``strategy="tp"`` on ``mesh`` (a mesh shape or ``parallel.Mesh``):
    ``COMPOSED_SHARD_RULES`` on a mesh with ``mdl`` and ``pp`` axes,
    ``SP_COMPOSED_SHARD_RULES`` on one with ``mdl`` and ``sp``, the stacked
    blocks over ``pp`` otherwise."""
    axes = _mesh_axes(mesh)
    if "mdl" in axes and "pp" in axes:
        return COMPOSED_SHARD_RULES
    return SP_COMPOSED_SHARD_RULES if "mdl" in axes and "sp" in axes else PP_SHARD_RULES


def _pipelined_block(p, carry, seq_mesh=None, tp=None, heads=None, hidden=None):
    """One pre-LN encoder block on the port's names (flax
    ``EncoderBlock(dim, heads, dropout=0.0)``: LayerNorm epsilon 1e-6, plain
    attention with the key padding mask, tanh GELU). ``carry``: ``(h,
    mask)`` with ``mask`` the (B, L) key mask as 0/1 floats. With
    ``seq_mesh`` (sequence parallel) ``h`` holds this rank's positions and
    the keys and values are gathered whole. With ``tp`` (the ``mdl`` view
    of a composed mesh) the block computes Megatron's tensor parallelism on
    this rank's ``heads/m`` heads and ``hidden/m`` MLP columns, each leaf
    taken as its chunk or cut from the whole (``_heads_qkv``, ``_heads_out``,
    ``_mlp``)."""
    h, mask = carry
    d = h.shape[-1]
    y = F.layer_norm(h, (d,), p["ln1.weight"], p["ln1.bias"], eps=1e-6)
    q, k, v = _heads_qkv(y, [p[f"attn.{n}.kernel"] for n in _QKV],
                         [p[f"attn.{n}.bias"] for n in _QKV], heads, tp)
    if seq_mesh is not None:
        from betty_tpu_torch.parallel.collectives import seq_gather

        k, v = seq_gather(k, seq_mesh, dim=2), seq_gather(v, seq_mesh, dim=2)
    o = reference_attention(q, k, v, mask > 0.5)
    h = h + _heads_out(o, p["attn.out.kernel"], p["attn.out.bias"], heads, tp)
    y = F.layer_norm(h, (d,), p["ln2.weight"], p["ln2.bias"], eps=1e-6)
    y = _mlp(y, p["fc1.weight"], p["fc1.bias"], p["fc2.weight"], p["fc2.bias"], hidden, tp)
    return (h + y, mask)


def _mesh_axes(mesh):
    """The axis names of ``mesh``: a ``parallel.Mesh`` or a mesh shape
    (``(("dp", 2), ("pp", 4))``, as ``EngineConfig.mesh_shape``)."""
    if mesh is None:
        return ()
    if hasattr(mesh, "shape") and isinstance(mesh.shape, dict):
        return tuple(mesh.shape)
    return tuple(n for n, _ in mesh)


def make_pipelined_transformer(mesh=None, *, vocab_size: int = 50265, max_len: int = 128,
                               dim: int = 256, depth: int = 4, heads: int = 8,
                               num_classes: int = 2, pad_id: int = 1, axis: str = "pp",
                               num_microbatches=None, seq_axis=None, seed: int = 0,
                               device=None, dtype=torch.float32):
    """A transformer classifier whose encoder stack runs as a GPipe
    pipeline over the mesh's ``axis`` (``parallel/pipeline.py``), as
    ``betty_tpu.models.make_pipelined_transformer``. Returns a
    ``FunctionalModule`` with params ``embed.tok`` (V, d), ``embed.pos`` (1,
    L, d), the stacked ``blocks.*`` (a leading depth dim; the attention
    kernels ``(d, H, Dh)``/``(H, Dh, d)``, ``fc1``/``fc2`` as ``nn.Linear``
    weights) and ``head.ln_scale``, ``ln_bias``, ``pool_w`` (d, d),
    ``pool_b``, ``out_w`` (d, C), ``out_b``.

    ``mesh``: None, a mesh shape (``EngineConfig.mesh_shape``) or a
    ``parallel.Mesh``. With ``axis`` among its axes the stack runs through
    ``gpipe`` over the mesh bound when the module is called (the engine's,
    or one bound with ``parallel.active``), and each rank computes on the
    stacked blocks it holds: shard them over ``pp`` with ``strategy="pp"``,
    or ``strategy="tp"`` and ``Config(shard_rules=((r"^blocks",
    ("pp",)),))``. ``num_microbatches``: M (default the axis size). Without
    the axis the stack runs one block after another (``sequential``): the
    same numbers on one device.

    On a mesh with ``mdl`` and ``pp`` axes (the JAX package's ``dp x mdl x
    pp``) each stage's blocks compute Megatron's tensor parallelism over
    the ``mdl`` group (``_pipelined_block`` with the ``mdl`` view): shard
    them with ``strategy="tp"`` and ``Config(shard_rules=
    COMPOSED_SHARD_RULES)`` (``pipelined_shard_rules``), the stage dim over
    ``pp`` and heads or MLP columns over ``mdl``. A leaf whole over ``mdl``
    is cut where it is used, so ``strategy="pp"`` there gives the same
    numbers with the blocks replicated over ``mdl``.

    ``seq_axis``: the sequence-parallel mode (not with pipelining: beside
    the pipeline's axis it is ignored, as in JAX, and its ranks repeat the
    stages' work): over the mesh's ``seq_axis`` the block input is split on
    the sequence, LayerNorm and the MLP run on the rank's ``L/S`` positions,
    attention on its queries against the keys and values gathered whole
    (``parallel.seq_gather``), and the head's masked pooled sum leaves
    through *g*. The leaves used on a sequence shard (the stacked blocks,
    the head's LayerNorm) enter through *f*, so their gradients are summed
    over the ``sp`` group once; the embedding's come whole through the
    split's backward (an all-gather), and ``pool_*``/``out_*`` are used on
    the replicated pooled vector. Beside a ``mdl`` axis each block also
    computes Megatron's tensor parallelism over it (Megatron-SP,
    arXiv:2205.05198 §4.2): its ``heads/m`` heads and ``hidden/m`` MLP
    columns on its positions, the keys and values gathered over ``sp``
    alone; shard the blocks with ``strategy="tp"`` and
    ``Config(shard_rules=SP_COMPOSED_SHARD_RULES)``, or keep them whole
    with ``strategy="sp"`` (each rank cuts its heads where it uses them).
    Any other model axis (``ep``) repeats the work.

    Blocks are dropout-free, as JAX's (microbatching would need a dropout
    stream a microbatch). ``seed``: the weights' seed (the JAX package's
    bits come over with ``convert.from_jax_pipelined``)."""
    from betty_tpu_torch.module import FunctionalModule
    from betty_tpu_torch.parallel.collectives import seq_split
    from betty_tpu_torch.parallel.pipeline import gpipe, sequential, stack_block_params

    device = torch.device(device if device is not None else "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape):
        t = torch.empty(shape, device=device, dtype=dtype)
        return normal_(t, 0.02, generator=gen)

    blocks = stack_block_params(lambda s: _init_block(dim, heads, s, device, dtype),
                                fold_in(seed, 1), depth)
    params = {"embed.tok": normal((vocab_size, dim)), "embed.pos": normal((1, max_len, dim))}
    params.update({f"blocks.{k}": v for k, v in blocks.items()})
    params.update({"head.ln_scale": torch.ones(dim, device=device, dtype=dtype),
                   "head.ln_bias": torch.zeros(dim, device=device, dtype=dtype),
                   "head.pool_w": normal((dim, dim)),
                   "head.pool_b": torch.zeros(dim, device=device, dtype=dtype),
                   "head.out_w": normal((dim, num_classes)),
                   "head.out_b": torch.zeros(num_classes, device=device, dtype=dtype)})

    axes = _mesh_axes(mesh)
    pipelined = axis in axes
    seq_parallel = not pipelined and seq_axis is not None and seq_axis in axes
    block_names = [k for k in params if k.startswith("blocks.")]
    hidden = params["blocks.fc1.weight"].shape[1]

    def apply_fn(variables, input_ids, train=True, rngs=None, mutable=(), **kwargs):
        p = variables["params"]
        L = input_ids.shape[1]
        pad_mask = input_ids != pad_id
        stacked = {k[len("blocks."):]: p[k] for k in block_names}
        x = F.embedding(input_ids, p["embed.tok"]) + p["embed.pos"][:, :L]
        mask = pad_mask.to(x.dtype)
        ln_scale, ln_bias = p["head.ln_scale"], p["head.ln_bias"]
        sp = axis_mesh(seq_axis) if seq_parallel else None
        if pipelined:
            pp = axis_mesh(axis)
            if pp is None:
                raise ValueError(f"make_pipelined_transformer: built for the {axis!r} axis, "
                                 "called with no mesh of that model axis bound (run it under "
                                 "the engine or parallel.active)")
            block = functools.partial(_pipelined_block, tp=axis_mesh("mdl"), heads=heads,
                                      hidden=hidden)
            x, _ = gpipe(block, stacked, (x, mask), pp, axis=axis,
                         num_microbatches=num_microbatches, depth=depth)
        elif sp is not None:
            # the leaves used on this rank's positions: f sums their gradients
            stacked = {k: copy_to_model(v, sp) for k, v in stacked.items()}
            ln_scale, ln_bias = copy_to_model(ln_scale, sp), copy_to_model(ln_bias, sp)
            block = functools.partial(_pipelined_block, seq_mesh=sp, tp=axis_mesh("mdl"),
                                      heads=heads, hidden=hidden)
            x, _ = sequential(block, stacked, (seq_split(x, sp, dim=1), mask))
            pad_mask = seq_split(mask, sp, dim=1) > 0.5
        else:
            x, _ = sequential(_pipelined_block, stacked, (x, mask))

        x = F.layer_norm(x, (x.shape[-1],), ln_scale, ln_bias, eps=1e-6)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        summed = (x * pad_mask[..., None]).sum(dim=1)
        if sp is not None:
            summed = reduce_from_model(summed, sp)
        pooled = torch.tanh(summed / denom @ p["head.pool_w"] + p["head.pool_b"])
        out = pooled @ p["head.out_w"] + p["head.out_b"]
        return (out, {}) if mutable else out

    # under pp each rank computes on its stage's blocks (dim 0), and beside
    # a mdl axis (with pp or sp) on its heads and MLP columns too: the
    # problem gathers neither
    composed = len([a for a in axes if a in MODEL_AXES]) > 1

    def cut(k):
        pairs = ((0, axis),) if pipelined else ()
        if "mdl" in axes and k[7:] in _PIPELINED_TP_DIMS:
            pairs += ((_PIPELINED_TP_DIMS[k[7:]], "mdl"),)
        return Cut(pairs) if pairs else None

    local = None
    if composed and (pipelined or seq_parallel):
        local = {k: cut(k) for k in block_names}
    elif pipelined:
        local = {k: 0 for k in block_names}
    return FunctionalModule(apply_fn, {"params": params}, rng_names=(), local_dims=local)
