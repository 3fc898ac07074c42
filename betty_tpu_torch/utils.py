"""Tree and logging utilities.

Counterpart of ``betty_tpu/utils.py``. A "tree" here is a nested structure
of dicts, lists and tuples with tensors at the leaves (a problem's params
dict maps parameter names to tensors); the helpers build new tensors and
never update in place, so a state that a roll-back cache holds stays valid.
The exceptions end in ``_`` (``tree_add_``, ``tree_zero_``, ``tree_copy_``):
they write into the storage of their first tree, with the kernel of the
out-of-place helper they stand for, and serve the donated updates
(``EngineConfig.donate_state``).
"""

from typing import Any
import zlib

import numpy as np
import torch


def require_device(device, who: str) -> torch.device:
    """``torch.device(device)``; raises if it is a CUDA device and there is
    no card (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' requested but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return device


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_paths(tree, prefix=()):
    """``(path, leaf)`` pairs in ``tree_leaves`` order; a path is the tuple
    of dict keys and sequence indices down to the leaf."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_paths(t, prefix + (i,))
    else:
        yield prefix, tree


def tree_map_named(fn, tree, *rest, prefix=()):
    """``fn(name, leaf, *rest leaves)`` leafwise, ``name`` the leaf's keys
    joined by "/" (a parameter's name as ``param_groups`` selectors and
    ``Config.shard_rules`` see it)."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, tree[k], *(r[k] for r in rest), prefix=prefix + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_named(fn, t, *(r[i] for r in rest), prefix=prefix + (i,))
                          for i, t in enumerate(tree))
    return fn("/".join(str(k) for k in prefix), tree, *rest)


def tree_add(a, b):
    """a + b, leafwise. ``None``-tolerant on either side (treated as zero)."""
    if a is None:
        return b
    if b is None:
        return a
    return tree_map(torch.add, a, b)


def tree_add_(a, b):
    """``a += b``, leafwise into ``a``'s storage: ``a.add_(b)`` is the kernel
    of ``torch.add(a, b)``, so the bits are ``tree_add``'s. Returns ``a``."""
    with torch.no_grad():
        tree_map(lambda x, y: x.add_(y), a, b)
    return a


def tree_zero_(a):
    """Every leaf of ``a`` set to zero in its storage (``tree_zeros_like``'s
    values). Returns ``a``."""
    with torch.no_grad():
        tree_map(lambda x: x.zero_(), a)
    return a


def _same_memory(x, y):
    return (x.data_ptr() == y.data_ptr() and x.shape == y.shape
            and x.stride() == y.stride() and x.dtype == y.dtype)


def tree_copy_(dst, src):
    """``src``'s values written into the storage of ``dst``, leafwise (the
    same structure, shapes and dtypes, or ``ValueError``). A leaf whose
    source already is its destination is left alone; a source that shares
    other memory with its destination is copied out first. Returns
    ``dst``."""
    def copy(d, s):
        if s is d or _same_memory(d, s):
            return d
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"tree_copy_: a {tuple(s.shape)} {s.dtype} value for a "
                             f"{tuple(d.shape)} {d.dtype} leaf")
        if s.untyped_storage().data_ptr() == d.untyped_storage().data_ptr():
            s = s.clone()
        return d.copy_(s)

    with torch.no_grad():
        tree_map(copy, dst, src)
    return dst


def tree_zip(tree, *rest):
    """The leaves of ``tree`` with the leaves at the same places in
    ``rest``, as tuples in ``tree_leaves`` order."""
    out = []
    tree_map(lambda *xs: out.append(xs), tree, *rest)
    return out


def unalias(tree):
    """``tree`` with every tensor leaf that shares memory with an earlier
    leaf replaced by a copy, so that no in-place update of one leaf writes
    another."""
    seen = set()

    def own(x):
        if not isinstance(x, torch.Tensor) or x.numel() == 0:
            return x
        key = (x.device, x.untyped_storage().data_ptr())
        if key in seen:
            return x.clone()
        seen.add(key)
        return x

    return tree_map(own, tree)


def tree_sub(a, b):
    """a - b, leafwise."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """s * a, leafwise (s a number or a 0-dim tensor)."""
    return tree_map(lambda x: s * x, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise (alpha a number or a 0-dim tensor)."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def neg(tree):
    """Leafwise negation."""
    return tree_map(torch.neg, tree)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def _promote(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def tree_dot(a, b):
    """Flattened dot product <vec(a), vec(b)>, in at least float32, as a
    0-dim tensor."""
    parts = tree_leaves(tree_map(
        lambda x, y: torch.dot(_promote(x).reshape(-1), _promote(y).reshape(-1)), a, b))
    return torch.stack(parts).sum()


def tree_norm(a):
    """Global L2 norm of a tree (``to_vec(v).norm()`` of the reference)."""
    return torch.sqrt(tree_dot(a, a))


def to_vec(tree, alpha=1.0):
    """The leaves of ``tree`` times ``alpha``, flattened and concatenated into
    one 1-D tensor in ``tree_leaves`` order."""
    return torch.cat([(alpha * x).reshape(-1) for x in tree_leaves(tree)])


def count_parameters(tree) -> int:
    """Number of elements over the leaves of ``tree``."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree))


def tree_where_mask(mask, a, b):
    """``a`` where ``mask`` else ``b``, leafwise; ``mask`` is a tree of bools
    (or bool tensors) of ``a``'s structure."""
    return tree_map(lambda m, x, y: torch.where(torch.as_tensor(m, device=x.device), x, y),
                    mask, a, b)


def tree_cast(tree, dtype):
    """Cast the floating-point leaves to ``dtype`` (the bf16 compute policy);
    integer and bool leaves and non-tensors pass through."""

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def clip_by_global_norm(tree, max_norm):
    """torch ``clip_grad_norm_`` semantics: scale = max_norm / (norm + 1e-6),
    applied only when the norm exceeds max_norm."""
    norm = tree_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree)


def fold_in(seed: int, data: int) -> int:
    """Derive a new 63-bit seed from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in`` for integer seeds; a splitmix64 round). Folding a
    :class:`StepSeed` gives a ``StepSeed`` that remembers the fold."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E5) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    z = (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF
    if isinstance(seed, StepSeed):
        return StepSeed(z, seed.base, seed.n, seed.chain + (int(data),))
    return z


class StepSeed(int):
    """A seed ``fold_in(base, n)`` folded further by ``chain``, which keeps
    that derivation: ``at(m)`` is the seed the same folds give at count
    ``m``. Compiled blocks hand each event's update such a seed, so the
    seeds a captured period draws can be derived again for every later
    period without running it."""

    def __new__(cls, value, base, n, chain=()):
        seed = int.__new__(cls, value)
        seed.base, seed.n, seed.chain = base, n, chain
        return seed

    @classmethod
    def make(cls, base: int, n: int) -> "StepSeed":
        return cls(fold_in(base, n), base, n)

    def at(self, n: int) -> int:
        seed = fold_in(self.base, n)
        for data in self.chain:
            seed = fold_in(seed, data)
        return seed


# ---------------------------------------------------------------------------
# Per-step host values. A step reads a few values from the host: its
# scheduled learning rate, Adam's bias corrections and the seeds of its
# dropout generators. Driver mode makes them here for every step; a
# compiled block (``betty_tpu_torch/compile.py``) installs a recorder that
# serves them from static device buffers and generators it reseeds before
# every replay of its captured period.
# ---------------------------------------------------------------------------

_STEP_VALUES = None


class step_values:
    """Scope in which ``step_scalar`` and ``seeded_generator`` go to
    ``recorder`` (``.scalar(fn, n, dtype, device)`` and
    ``.generator(seed, device)``)."""

    def __init__(self, recorder):
        self.recorder = recorder

    def __enter__(self):
        global _STEP_VALUES
        self._saved = _STEP_VALUES
        _STEP_VALUES = self.recorder
        return self.recorder

    def __exit__(self, *exc):
        global _STEP_VALUES
        _STEP_VALUES = self._saved
        return False


def step_scalar(fn, n: int, like: torch.Tensor) -> torch.Tensor:
    """``fn(n)``, a per-step value computed on the host from the integer
    ``n`` (a scheduler step, an optimizer count), as a 0-d tensor of
    ``like``'s floating dtype (at least float32) on ``like``'s device. A
    0-d device tensor, not a Python number: on CUDA, ``tensor / number``
    multiplies by the reciprocal, while ``tensor / tensor`` divides as optax
    does, and a captured period reads the value from device memory."""
    dtype = torch.promote_types(like.dtype, torch.float32)
    if _STEP_VALUES is not None:
        return _STEP_VALUES.scalar(fn, n, dtype, like.device)
    return torch.full((), float(fn(n)), dtype=dtype, device=like.device)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (a module's
    dropout stream for one forward)."""
    if _STEP_VALUES is not None:
        return _STEP_VALUES.generator(seed, device)
    return torch.Generator(device=device).manual_seed(int(seed))


def fold_rng_name(seed: int, name: str) -> int:
    """Stable per-collection seed fold (crc32, not the salted ``hash()``)."""
    return fold_in(seed, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def get_dtype(precision: str):
    if precision in ("fp16", "bf16"):
        return torch.bfloat16
    return torch.float32


def convert_scalar(value) -> Any:
    """Tensor or numpy scalar -> Python number for logging."""
    if isinstance(value, torch.Tensor):
        return value.item() if value.numel() == 1 else value.detach().cpu().numpy()
    if isinstance(value, np.generic):
        return value.item()
    return value


def log_from_loss_dict(loss_dict) -> str:
    """Format a metrics dict for stdout logging."""
    outputs = []
    for key, values in loss_dict.items():
        if isinstance(values, dict):
            for k2, v in values.items():
                outputs.append(f"{key}_{k2}: {convert_scalar(v)}")
        elif isinstance(values, (list, tuple)):
            for idx, v in enumerate(values):
                outputs.append(f"{key}_{idx}: {convert_scalar(v)}")
        else:
            outputs.append(f"{key}: {convert_scalar(values)}")
    return " || ".join(outputs)


def _differentiable(x):
    """``x`` itself if it is already part of a graph, else a leaf that
    requires grad (a constant has no graph to cut)."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def value_and_grad(fn, *args, argnums=(0,), has_aux=False, create_graph=False):
    """Reverse-mode gradient of a scalar function of trees of tensors, in the
    shape of ``jax.value_and_grad``: returns ``(value, grads)`` or, with
    ``has_aux``, ``((value, aux), grads)``; ``grads`` is one tree for an int
    ``argnums`` and a tuple of trees otherwise. Leaves the value does not
    depend on get zero gradients; value and aux come back detached.

    With ``create_graph`` the graph is kept, for a derivative of the
    gradients themselves (iterative differentiation,
    ``problems/iterative.py``): an argument that is already part of a graph
    is not detached, the gradients are taken with ``create_graph=True``,
    and value, aux and gradients stay differentiable functions of whatever
    the arguments and ``fn`` depend on."""
    single = isinstance(argnums, int)
    nums = (argnums,) if single else tuple(argnums)
    args = list(args)
    leaf = _differentiable if create_graph else (lambda x: x.detach().requires_grad_(True))
    for i in nums:
        args[i] = tree_map(leaf, args[i])
    with torch.enable_grad():
        out = fn(*args)
        value, aux = out if has_aux else (out, None)
        leaves = [x for i in nums for x in tree_leaves(args[i])]
        if value.requires_grad and leaves:
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        create_graph=create_graph)
        else:
            grads = [None] * len(leaves)
    flat = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    trees, pos = [], 0
    for i in nums:
        n = len(tree_leaves(args[i]))
        it = iter(flat[pos:pos + n])
        trees.append(tree_map(lambda _x: next(it), args[i]))
        pos += n
    grads_out = trees[0] if single else tuple(trees)
    if create_graph:
        return ((value, aux), grads_out) if has_aux else (value, grads_out)
    value = value.detach()
    if has_aux:
        aux = tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, aux)
        return (value, aux), grads_out
    return value, grads_out


def grad(fn, argnums=0):
    """``jax.grad`` counterpart over :func:`value_and_grad`."""

    def wrapped(*args):
        return value_and_grad(fn, *args, argnums=argnums)[1]

    return wrapped
