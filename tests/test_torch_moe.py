"""The Switch MoE layer (``betty_tpu_torch/models/moe.py``) and its bilevel
program (``examples/moe_reweighting.py``) against the JAX package's
``betty_tpu/models/moe.py`` and ``tests/test_ep.py``'s program.

* float32, in this process: ``moe_ffn`` for capacities T, 2 and the
  default, and ``moe_ffn_dense``, at DIM 16 / HID 32 / E 4 / T 64: ``y``
  and ``aux`` within 1e-5.
* float64 (``torch_moe_impl.py``, in a subprocess): the same within 1e-12,
  the gradients of every parameter and of ``x`` within 1e-10, and the
  program after 4 iterations in driver mode and compiled within 1e-10.
* bf16 at T 1024 / E 2 (about 512 tokens an expert, past the 256 up to
  which a bf16 cumsum counts exactly): the port's dispatch tensor equals
  the one JAX's ``moe_ffn`` builds (read from its dispatch einsum), and
  each expert's kept positions are 0..min(n_e, C) - 1, each once.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.models import moe as jmoe
from betty_tpu_torch import convert
from betty_tpu_torch.examples import moe_reweighting as tex
from betty_tpu_torch.models import init_moe_params, moe_ffn, moe_ffn_dense
from betty_tpu_torch.models import moe as tmoe
from betty_tpu_torch.utils import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DIM, HID, E, T = 16, 32, 4, 64


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype_np=np.float32, seed=0, dim=DIM, hid=HID, experts=E, tokens=T):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), dim, hid, experts)
    x = np.random.RandomState(seed + 1).randn(tokens, dim).astype(dtype_np)
    return jp, x


@pytest.mark.parametrize("capacity", [T, 2, None, "dense"])
def test_moe_ffn_matches_jax_float32(capacity):
    jp, x = _setup()
    tp = convert.from_jax_moe(jax.tree_util.tree_map(np.asarray, jp))
    if capacity == "dense":
        yj, auxj = jmoe.moe_ffn_dense(jp, jnp.asarray(x))
        yt, auxt = moe_ffn_dense(tp, torch.from_numpy(x))
    else:
        yj, auxj = jmoe.moe_ffn(jp, jnp.asarray(x), capacity=capacity)
        yt, auxt = moe_ffn(tp, torch.from_numpy(x), capacity=capacity)
    assert yt.shape == (T, DIM) and yt.dtype == torch.float32
    assert float(np.abs(np.asarray(yj) - yt.numpy()).max()) <= 1e-5
    assert abs(float(auxj) - float(auxt)) <= 1e-5
    dropped = np.all(yt.numpy() == 0.0, axis=1).sum()
    assert (dropped > 0) == (capacity == 2)


@pytest.fixture(scope="module")
def float64_runs():
    """Every case of ``torch_moe_impl.py`` in one subprocess, on few threads,
    since the test workers share the machine's cores."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    return subprocess.run([sys.executable, str(ROOT / "tests" / "torch_moe_impl.py"),
                           "layer", "driver", "compiled"],
                          capture_output=True, text=True, env=env, timeout=600)


@pytest.mark.parametrize("case", ["layer", "driver", "compiled"])
def test_moe_matches_jax_in_float64(float64_runs, case):
    lines = [line for line in float64_runs.stdout.splitlines() if f'"case": "{case}"' in line]
    print(float64_runs.stdout)
    print(float64_runs.stderr[-3000:], file=sys.stderr)
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def _jax_dispatch(monkeypatch, jp, x):
    """JAX's ``moe_ffn`` output and the dispatch tensor it builds, read from
    its dispatch einsum."""
    real, seen = jmoe.jnp, {}

    class Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        def einsum(self, spec, *operands):
            if spec == "tec,td->ecd":
                seen["dispatch"] = operands[0]
            return real.einsum(spec, *operands)

    monkeypatch.setattr(jmoe, "jnp", Recorder())
    out = jmoe.moe_ffn(jp, x)
    monkeypatch.setattr(jmoe, "jnp", real)
    return out, np.asarray(seen["dispatch"].astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_dispatch_matches_jax_past_256(monkeypatch, seed):
    tokens, experts = 1024, 2
    jp, x = _setup(seed=seed, experts=experts, tokens=tokens)
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    (yj, auxj), want = _jax_dispatch(monkeypatch, jb, jnp.asarray(x, jnp.bfloat16))
    tp = convert.from_jax_moe(jax.tree_util.tree_map(np.asarray, jp), dtype=torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    C = tmoe.expert_capacity(tokens, experts)
    gate, onehot, dispatch = tmoe.route(tmoe.router_probs(tp["router"], xt), C, xt.dtype)
    assert dispatch.dtype == onehot.dtype == torch.bfloat16 and C == 640
    got = dispatch.float().numpy()
    assert np.array_equal(got, want)
    routed = onehot.float().sum(0).numpy()  # exact: float32 sums of 0/1
    assert routed.max() > 256
    for e in range(experts):
        slots = got[:, e, :]
        used = slots.sum(axis=0)
        n_kept = int(min(routed[e], C))
        assert np.array_equal(used[:n_kept], np.ones(n_kept)) and not used[n_kept:].any()
    yt, auxt = moe_ffn(tp, xt)
    assert yt.dtype == torch.bfloat16 and float(auxt) == float(auxj)


def test_init_moe_params_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = init_moe_params(g, 64, 256, 8, dtype=torch.float64)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 8), "w1": (8, 64, 256), "b1": (8, 256), "w2": (8, 256, 64), "b2": (8, 64)}
    assert all(v.dtype == torch.float64 for v in p.values())
    assert abs(float(p["w1"].std()) * 8.0 - 1.0) < 0.05  # 1/sqrt(dim)
    assert abs(float(p["w2"].std()) * 16.0 - 1.0) < 0.05  # 1/sqrt(hidden)
    assert not p["b1"].any() and not p["b2"].any()
    again = init_moe_params(torch.Generator().manual_seed(0), 64, 256, 8, dtype=torch.float64)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_program_defaults_are_switch_base_8():
    args = tex.parse_args([])
    assert (args.dim, args.hidden, args.experts, tex.CAPACITY_FACTOR) == (768, 3072, 8, 1.25)
    assert args.tokens == args.val_tokens == 4096 and args.device == "cuda"
    assert tmoe.expert_capacity(args.tokens, args.experts, tex.CAPACITY_FACTOR) == 640


def test_program_bf16_compiled_equals_driver():
    argv = ["--device", "cpu", "--dim", "16", "--hidden", "32", "--experts", "4", "--tokens",
            "64", "--val_tokens", "32", "--precision", "bf16", "--train_iters", "6"]
    runs = []
    for extra in ([], ["--compile_blocks"]):
        engine = tex.build_engine(tex.parse_args(argv + extra))
        engine.config.block_periods = 1
        engine.run()
        runs.append(engine)
    assert runs[1].block_runner is not None and runs[1].block_runner.periods_run >= 1
    for name in ("inner", "outer"):
        a = runs[0].states[name]["params"]
        b = runs[1].states[name]["params"]
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    leaves = tree_leaves(runs[0].states["inner"]["params"])
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in leaves)
