"""Helpers of the DARTS tests: the port's weights as flax variables (the
inverse of ``convert.from_flax_darts``), a functional apply of a port
module that returns its new running statistics, and ``compare``, which
runs a flax module and the port's counterpart on the same inputs and
weights and returns their differences; ``check_supernet``, the supernet's
case of that comparison, and ``run_nas_impl``, which runs a case of
``torch_nas_impl.py`` in a subprocess."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from betty_tpu_torch import convert
from betty_tpu_torch.models.batchnorm import BatchNorm

TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def one_thread():
    """Pin torch to one thread for a test (a fixture's body): the small ops
    of these tests spread over every core wait for all of them, many times
    slower when the test workers load the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_flax(net, params, stats, dtype=np.float64):
    """``net``'s params and batch_stats (dicts of tensors by the port's
    names) as flax variables of numpy arrays: conv weights OIHW -> HWIO,
    linear weights transposed, BatchNorm weight/bias -> scale/bias."""
    def arr(t):
        return t.detach().cpu().numpy().astype(dtype)

    def walk(module, prefix, pt, st):
        counts = {}
        for path, child in convert._flax_children(module, prefix):
            kind = convert._flax_name(child)
            if kind is None:
                continue
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            if kind == "Conv":
                pt[name] = {"kernel": np.transpose(arr(params[f"{path}.weight"]), (2, 3, 1, 0))}
            elif kind == "Dense":
                pt[name] = {"kernel": arr(params[f"{path}.weight"]).T,
                            "bias": arr(params[f"{path}.bias"])}
            elif isinstance(child, BatchNorm):
                if child.weight is not None:
                    pt[name] = {"scale": arr(params[f"{path}.weight"]),
                                "bias": arr(params[f"{path}.bias"])}
                st[name] = {"mean": arr(stats[f"{path}.running_mean"]),
                            "var": arr(stats[f"{path}.running_var"])}
            else:
                sub_p, sub_s = {}, {}
                walk(child, f"{path}.", sub_p, sub_s)
                if sub_p:
                    pt[name] = sub_p
                if sub_s:
                    st[name] = sub_s

    p, s = {}, {}
    walk(net, "", p, s)
    return {"params": p, "batch_stats": s}


def module_state(net, dtype=torch.float64):
    """``net``'s own params and buffers, as dicts of ``dtype`` tensors."""
    params = {k: t.detach().to(dtype) for k, t in net.named_parameters()}
    stats = {k: t.detach().to(dtype) for k, t in net.named_buffers()}
    return params, stats


def port_apply(net, params, stats, *args, train=True, **kwargs):
    """``net(*args)`` on ``params``/``stats`` through ``functional_call``;
    returns ``(out, new batch_stats by name)`` (train mode reports them)."""
    updates = {}
    out = torch.func.functional_call(net, {**params, **stats}, args,
                                     {**kwargs, "train": train, "updates": updates})
    names = {m: n for n, m in net.named_modules()}
    new = {(f"{names[m]}." if names[m] else "") + k: v for (m, k), v in updates.items()}
    return out, new


def with_stats(net, seed=1):
    """``net`` with running statistics away from 0 and 1, so that eval mode
    reads real ones."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            else:
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return net


def _host(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(1.0, float(np.abs(want).max()))


def _to_torch(x, dtype, grad):
    if isinstance(x, dict):
        return {k: _to_torch(v, dtype, grad) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.tensor(x, dtype=dtype).requires_grad_(grad)
    return x


def _leaves(x):
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [x] if torch.is_tensor(x) else []


def compare(jmod, tnet, inputs, dtype, extra=(), train=True, nchw=True):
    """flax ``jmod`` and the port's ``tnet`` (same structure, the port's
    weights in both) on ``inputs`` (NHWC numpy images) and ``extra``
    arguments (numpy arrays or dicts of them, which get gradients; numbers
    pass as they are). Train mode: outputs, new running statistics, and
    the gradients of sum(out * R) to the params, the inputs and the extra
    arrays; eval mode: outputs. ``nchw``: the port's module takes NCHW
    (an op, a cell), else NHWC like flax (a network). Returns the errors by name, each relative
    to max(1, max|flax|), the parameter gradient's to the largest entry of
    the whole tree."""
    import jax

    with jax.enable_x64(dtype == torch.float64):
        return _compare(jmod, tnet, inputs, dtype, extra, train, nchw)


def _compare(jmod, tnet, inputs, dtype, extra, train, nchw):
    import jax
    import jax.numpy as jnp

    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    params, stats = module_state(tnet, dtype)
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), to_flax(tnet, params, stats))
    cast = lambda x: jnp.asarray(x, jd) if isinstance(x, np.ndarray) else x  # noqa: E731
    xs_j = [jnp.asarray(x, jd) for x in inputs]
    # arrays and dicts of them are differentiated; numbers stay constants
    static = [not isinstance(e, (np.ndarray, dict)) for e in extra]
    ex_j = [None if st else jax.tree_util.tree_map(cast, e) for st, e in zip(static, extra)]

    def r_like(i, shape):
        return np.random.RandomState(5 + i).randn(*shape)

    def jloss(p, xs, ex):
        ex = [e if st else x for st, e, x in zip(static, extra, ex)]
        v = {"params": p, "batch_stats": variables["batch_stats"]}
        if train:
            out, mut = jmod.apply(v, *xs, *ex, train=True, mutable=["batch_stats"])
        else:
            out, mut = jmod.apply(v, *xs, *ex, train=False), {}
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(jnp.sum(o * jnp.asarray(r_like(i, o.shape), jd))
                   for i, o in enumerate(outs) if o is not None)
        return loss, (outs, mut)

    if train:
        (_, (jouts, jmut)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            variables.get("params", {}), xs_j, ex_j)
    else:
        _, (jouts, jmut) = jloss(variables.get("params", {}), xs_j, ex_j)

    p = {k: t.clone().requires_grad_(train) for k, t in params.items()}
    layout = (lambda t: t.permute(0, 3, 1, 2)) if nchw else (lambda t: t)  # noqa: E731
    xs_t = [layout(torch.tensor(x, dtype=dtype)).requires_grad_(train) for x in inputs]
    ex_t = [_to_torch(e, dtype, train) for e in extra]
    out, new = port_apply(tnet, p, stats, *xs_t, *ex_t, train=train)
    outs = out if isinstance(out, tuple) else (out,)
    nhwc = [o.permute(0, 2, 3, 1) if o is not None and o.dim() == 4 else o for o in outs]
    errs = {}
    assert len(nhwc) == len(jouts)
    for i, (o, jo) in enumerate(zip(nhwc, jouts)):
        assert (o is None) == (jo is None)
        if o is not None:
            errs[f"out {i}"] = _rel(o.detach().numpy(), jo)
    if not train:
        assert not new
        return errs

    loss = sum((o * torch.tensor(r_like(i, o.shape), dtype=dtype)).sum()
               for i, o in enumerate(nhwc) if o is not None)
    ex_leaves = [t for e in ex_t for t in _leaves(e)]
    leaves = list(p.values()) + xs_t + ex_leaves
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    tgrads = dict(zip(p, grads))

    want_stats = convert.from_flax_darts(
        {"params": _host(variables.get("params", {})),
         "batch_stats": _host(jmut.get("batch_stats", {}))}, tnet, dtype=torch.float64)[1]
    assert set(new) == set(want_stats) == set(stats)
    for k, v in want_stats.items():
        errs[f"stat {k}"] = _rel(new[k].detach().numpy(), v.numpy())
    want_grads = convert.from_flax_darts(
        {"params": _host(jgrads[0]), "batch_stats": _host(variables["batch_stats"])}, tnet,
        dtype=torch.float64)[0]
    assert set(want_grads) == set(params)
    # one scale for the parameter gradient: its largest entry
    scale = max([1.0] + [float(v.abs().max()) for v in want_grads.values()])
    for k, v in want_grads.items():
        errs[f"grad {k}"] = float((tgrads[k] - v).abs().max()) / scale
    for i, g in enumerate(jgrads[1]):
        g_t = grads[len(p) + i]
        errs[f"grad x{i}"] = _rel((g_t.permute(0, 2, 3, 1) if nchw else g_t).numpy(), g)
    jex = [np.asarray(t) for e in jgrads[2] if e is not None
           for t in jax.tree_util.tree_leaves(e)]
    for i, (g, jg) in enumerate(zip(grads[len(p) + len(xs_t):], jex)):
        errs[f"grad extra {i}"] = _rel(g.numpy(), jg)
    assert len(jex) == len(ex_leaves)
    return errs


def assert_within(errs, dtype):
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL[dtype], (worst, errs[worst], TOL[dtype])


def equal_trees(a, b):
    """Two state trees equal leaf for leaf: tensors bit for bit, of one
    dtype."""
    from betty_tpu_torch.utils import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def check_supernet(train, dtype):
    """The supernet ``DARTSNetwork`` at C4 L3 against flax's on 16x16
    numpy-seeded images and random alphas, within ``TOL[dtype]``: logits,
    the new running statistics of its 359 BatchNorms and the gradients to
    the params and both alphas (train mode), or eval-mode logits on the
    running statistics."""
    from betty_tpu.models import darts as J
    from betty_tpu_torch.models import darts as T

    rng = np.random.RandomState(0)
    alphas = {k: rng.randn(*T.num_alphas()) for k in ("normal", "reduce")}
    images = np.random.RandomState(0).randn(4, 16, 16, 3)
    net = with_stats(T.DARTSNetwork(channels=4, layers=3))
    assert sum(isinstance(m, T.BatchNorm) for m in net.modules()) == 359
    errs = compare(J.DARTSNetwork(channels=4, layers=3), net, [images], dtype, extra=[alphas],
                   train=train, nchw=False)
    if train:
        assert sum(k.startswith("grad extra") for k in errs) == 2  # normal and reduce
        assert sum(k.startswith("stat") for k in errs) == 2 * 359
    assert_within(errs, dtype)


def run_nas_impl(case):
    """``torch_nas_impl.py <case>`` in a subprocess (float64 JAX must not
    leak into the test process), one thread a framework (the test workers
    share the machine's cores); asserts its ``OK`` line."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    run = subprocess.run([sys.executable, str(Path(__file__).with_name("torch_nas_impl.py")),
                          case], capture_output=True, text=True, env=env, timeout=900)
    print(run.stdout)
    print(run.stderr[-3000:], file=sys.stderr)
    lines = [line for line in run.stdout.splitlines() if f'"case": "{case}"' in line]
    assert run.returncode == 0 and len(lines) == 1 and lines[0].startswith("OK "), lines
