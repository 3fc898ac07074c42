"""Vector kernels of the CG and Neumann solvers: hand-written CUDA for
Hopper, their plain PyTorch versions, and the flat-vector view of a
parameter tree.

Counterpart of ``betty_tpu/ops/vector.py``. The solvers' fused loops
(``Config.use_fused_vector_ops``) ravel the parameter tree into one float32
vector and run one iteration's vector algebra as a single pass over it:

* ``fused_dot2`` launches ``vector_dot2`` (``csrc/vector_ops.cu``), the port
  of ``_dot2_kernel``: ``(<a,b>, <c,d>)`` in one read of four vectors;
* ``cg_fused_step`` launches ``vector_cg_step``, the port of
  ``_cg_step_kernel``: ``x' = x + ak*p``, ``r' = r - ak*hvp`` and
  ``<r',r'>`` in one pass; ``ak`` may be a 0-dim device tensor, read by the
  kernel, so a CG solve never waits for the host;
* ``neumann_fused_step`` launches ``vector_neumann_step``, the port of
  ``_neumann_step_kernel``: ``v' = v - alpha*hv``, ``p' = p + v'``.

On a CPU tensor each wrapper computes its plain version (``*_plain``:
``torch.dot`` and elementwise expressions, in the inputs' dtype). On a CUDA
tensor it launches the kernel, on the current stream, or raises; nothing
falls back. The kernels take contiguous, 16-byte aligned float32 vectors of
equal length, any length; dots come back as 0-dim tensors on the device.
Each wrapper counts its launches in ``.launches``.
"""

import ctypes

import torch

from betty_tpu_torch.ops import _build
from betty_tpu_torch.utils import tree_leaves, tree_map

TILE = 8 * 1024  # ravel padding: the JAX kernels' tile, kept so both paths see equal lengths

_NAME = "vector_ops"


def _lib():
    p, ll, f, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    return _build.load(_NAME, {
        "vector_scratch_floats": ([], i),
        "vector_dot2": ([p] * 4 + [ll, p, p, p], i),
        "vector_cg_step": ([p] * 7 + [ll, p, p, p], i),
        "vector_neumann_step": ([f] + [p] * 5 + [ll, p], i),
    })


# ---------------------------------------------------------------------------
# tree <-> flat vector
# ---------------------------------------------------------------------------


def tree_ravel(tree):
    """Flatten the leaves into one vector zero-padded to a TILE multiple;
    returns ``(flat, n)`` with ``n`` the unpadded length. float32, or
    float64 when a leaf is float64."""
    leaves = tree_leaves(tree)
    dtype = torch.float32
    for x in leaves:
        dtype = torch.promote_types(dtype, x.dtype)
    n = sum(x.numel() for x in leaves)
    pad = -n % TILE
    parts = [x.reshape(-1).to(dtype) for x in leaves]
    if pad:
        parts.append(torch.zeros(pad, dtype=dtype, device=leaves[0].device))
    return torch.cat(parts), n


def tree_unravel(tree, flat):
    """Inverse of ``tree_ravel`` against a template tree: views of ``flat``
    in the template's shapes, cast to its leaves' dtypes."""
    offset = 0

    def take(x):
        nonlocal offset
        size = x.numel()
        out = flat[offset:offset + size].reshape(x.shape).to(x.dtype)
        offset += size
        return out

    return tree_map(take, tree)


# ---------------------------------------------------------------------------
# plain versions (what the kernels compute)
# ---------------------------------------------------------------------------


def fused_dot2_plain(a, b, c, d):
    return torch.dot(a, b), torch.dot(c, d)


def cg_fused_step_plain(ak, x, p, r, hvp):
    r_new = r - ak * hvp
    return x + ak * p, r_new, torch.dot(r_new, r_new)


def neumann_fused_step_plain(alpha, v, hv, p):
    v_new = v - alpha * hv
    return v_new, p + v_new


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(name, *vectors):
    """Check shapes and devices; True for CPU tensors (plain version), False
    for CUDA tensors the kernel takes; raises for anything else."""
    first = vectors[0]
    for v in vectors:
        if v.dim() != 1 or v.numel() != first.numel():
            raise ValueError(f"{name}: expects 1-D vectors of equal length, got shapes "
                             f"{[tuple(t.shape) for t in vectors]}")
        if v.device != first.device:
            raise ValueError(f"{name}: vectors on different devices")
    if first.device.type == "cpu":
        return True
    if first.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {first.device}")
    for v in vectors:
        if v.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 vectors, got {v.dtype}")
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous 16-byte aligned vectors")
    return False


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _scratch(device):
    """Per-block partial sums of a dot; freed after the call, which is safe
    because the caching allocator reuses it only in this stream's order."""
    return torch.empty(_lib().vector_scratch_floats(), dtype=torch.float32, device=device)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fused_dot2(a, b, c, d):
    """B6: ``(<a,b>, <c,d>)`` as two 0-dim tensors."""
    if _on_cpu("fused_dot2", a, b, c, d):
        return fused_dot2_plain(a, b, c, d)
    out = torch.empty(2, dtype=torch.float32, device=a.device)
    scratch = _scratch(a.device)
    err = _lib().vector_dot2(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), a.numel(),
                             scratch.data_ptr(), out.data_ptr(), _stream(a.device))
    _check(err, "vector_dot2")
    fused_dot2.launches += 1
    return out[0], out[1]


fused_dot2.launches = 0


def cg_fused_step(ak, x, p, r, hvp):
    """B7: ``(x + ak*p, r - ak*hvp, <r', r'>)``; ``ak`` a number or a 0-dim
    tensor."""
    if _on_cpu("cg_fused_step", x, p, r, hvp):
        return cg_fused_step_plain(ak, x, p, r, hvp)
    ak = torch.as_tensor(ak, dtype=torch.float32, device=x.device)
    if ak.numel() != 1:
        raise ValueError(f"cg_fused_step: ak must be a scalar, got shape {tuple(ak.shape)}")
    ak = ak.reshape(()).contiguous()
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    rr = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = _scratch(x.device)
    err = _lib().vector_cg_step(ak.data_ptr(), x.data_ptr(), p.data_ptr(), r.data_ptr(),
                                hvp.data_ptr(), x_out.data_ptr(), r_out.data_ptr(), x.numel(),
                                scratch.data_ptr(), rr.data_ptr(), _stream(x.device))
    _check(err, "vector_cg_step")
    cg_fused_step.launches += 1
    return x_out, r_out, rr


cg_fused_step.launches = 0


def neumann_fused_step(alpha, v, hv, p):
    """B8: ``(v - alpha*hv, p + v')``; ``alpha`` a number."""
    if _on_cpu("neumann_fused_step", v, hv, p):
        return neumann_fused_step_plain(alpha, v, hv, p)
    v_out, p_out = torch.empty_like(v), torch.empty_like(p)
    err = _lib().vector_neumann_step(float(alpha), v.data_ptr(), hv.data_ptr(), p.data_ptr(),
                                     v_out.data_ptr(), p_out.data_ptr(), v.numel(),
                                     _stream(v.device))
    _check(err, "vector_neumann_step")
    neumann_fused_step.launches += 1
    return v_out, p_out


neumann_fused_step.launches = 0


def reset_launch_counts():
    fused_dot2.launches = 0
    cg_fused_step.launches = 0
    neumann_fused_step.launches = 0
