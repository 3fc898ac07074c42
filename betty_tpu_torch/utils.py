"""Tree and logging utilities.

Counterpart of ``betty_tpu/utils.py``. A "tree" here is a nested structure
of dicts, lists and tuples with tensors at the leaves (a problem's params
dict maps parameter names to tensors); the helpers build new tensors and
never update in place, so a state that a roll-back cache holds stays valid.
"""

from typing import Any
import zlib

import numpy as np
import torch


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


def tree_add(a, b):
    """a + b, leafwise. ``None``-tolerant on either side (treated as zero)."""
    if a is None:
        return b
    if b is None:
        return a
    return tree_map(torch.add, a, b)


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
    ``jax.random.fold_in`` for integer seeds; a splitmix64 round)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E5) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


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


def value_and_grad(fn, *args, argnums=(0,), has_aux=False):
    """Reverse-mode gradient of a scalar function of trees of tensors, in the
    shape of ``jax.value_and_grad``: returns ``(value, grads)`` or, with
    ``has_aux``, ``((value, aux), grads)``; ``grads`` is one tree for an int
    ``argnums`` and a tuple of trees otherwise. Leaves the value does not
    depend on get zero gradients; value and aux come back detached."""
    single = isinstance(argnums, int)
    nums = (argnums,) if single else tuple(argnums)
    args = list(args)
    for i in nums:
        args[i] = tree_map(lambda x: x.detach().requires_grad_(True), args[i])
    with torch.enable_grad():
        out = fn(*args)
        value, aux = out if has_aux else (out, None)
        leaves = [x for i in nums for x in tree_leaves(args[i])]
        if value.requires_grad and leaves:
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
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
