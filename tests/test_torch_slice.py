"""The whole slice: data reweighting of a small transformer, run by the JAX
example and by the port from the same initial weights (moved across with
``betty_tpu_torch.convert``) on the same batches. SAMA and darts run with
``--flash``; CG and Neumann run the plain attention with 3 solver
iterations and the fused vector loops. SAMA also runs at ``--seq_len 1024``,
where ``--flash`` takes the multi-tile path (B3-B5) on both sides. After 4 classifier steps and 2
reweight steps (unroll 2) the parameters of both problems agree within 1e-4
in float32 (ROADMAP §C: the attention key bias, whose true gradient is zero,
is the leaf nearest that bound), and the graph's paths and the step counts
are the same.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from betty_tpu_torch import convert
from betty_tpu_torch.examples import bert_data_reweighting as tex

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--dim", "64", "--depth", "2", "--heads", "4", "--seq_len", "16",
        "--batch_size", "4", "--train_size", "64", "--meta_size", "32",
        "--flash", "--precision", "fp32", "--dropout", "0", "--unroll_steps", "2",
        "--train_iters", "4"]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "bert_torch_slice", ROOT / "examples" / "bert_data_reweighting" / "main.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bert_torch_slice"] = mod
    spec.loader.exec_module(mod)
    return mod


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _engines(argv, **solver_config):
    """The JAX example's engine and the port's, on the JAX engine's initial
    weights; ``solver_config`` goes into both classifiers' ``Config``."""
    jmod = _jax_example()
    jeng = jmod.build_engine(jmod.parse_args(argv))
    if solver_config:
        jeng.classifier._config = dataclasses.replace(jeng.classifier.config, **solver_config)
    teng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu"]), **solver_config)
    teng.states["classifier"]["params"] = convert.from_flax_transformer(
        _numpy(jeng.states["classifier"]["params"]))
    teng.states["reweight"]["params"] = convert.from_flax_mwn(
        _numpy(jeng.states["reweight"]["params"]))
    return jmod, jeng, teng


def _assert_same_params(jeng, teng):
    want_c = convert.from_flax_transformer(_numpy(jeng.states["classifier"]["params"]))
    want_r = convert.from_flax_mwn(_numpy(jeng.states["reweight"]["params"]))
    for name, want in (("classifier", want_c), ("reweight", want_r)):
        got = teng.states[name]["params"]
        assert set(got) == set(want)
        for k in want:
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-4, (name, k, err)
    return want_r


@pytest.mark.parametrize("hypergradient", ["sama", "darts"])
def test_small_reweighting_run_matches_jax(hypergradient):
    argv = ARGV + ["--hypergradient", hypergradient]
    jmod, jeng, teng = _engines(argv)

    names = lambda paths: [[p.name for p in path] for path in paths]  # noqa: E731
    assert names(teng.reweight.paths) == names(jeng.reweight.paths) == [
        ["reweight", "classifier", "reweight"]]
    assert names(teng.classifier.paths) == names(jeng.classifier.paths) == []
    assert [p.name for p in teng.leaves] == [p.name for p in jeng.leaves] == ["classifier"]

    jeng.run()
    teng.run()
    assert (teng.classifier.count, teng.reweight.count) == (4, 2)
    assert (jeng.classifier.count, jeng.reweight.count) == (4, 2)
    want_r = _assert_same_params(jeng, teng)
    # the reweighter really moved
    init_r = convert.from_flax_mwn(_numpy(jmod.build_engine(
        jmod.parse_args(argv)).states["reweight"]["params"]))
    assert any(float((want_r[k] - init_r[k]).abs().max()) > 0 for k in want_r)


def test_long_sequence_sama_run_matches_jax(monkeypatch):
    """SAMA with ``--flash`` at S1024 (dim 32, one layer, batch 2): the
    attention runs the multi-tile path (the JAX default blocks are 512), and
    the parameters agree within 1e-4 after 4 + 2 steps."""
    from betty_tpu_torch.ops import flash_attention as tfa

    paths = []
    for name in ("_fwd_single", "_fwd_multi"):
        def spy(*a, _orig=getattr(tfa, name), _name=name, **kw):
            paths.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(tfa, name, spy)
    argv = ARGV[:]
    for flag, value in (("--dim", "32"), ("--depth", "1"), ("--seq_len", "1024"),
                        ("--batch_size", "2")):
        argv[argv.index(flag) + 1] = value
    _, jeng, teng = _engines(argv + ["--hypergradient", "sama"])
    rw0 = {k: v.clone() for k, v in teng.states["reweight"]["params"].items()}
    jeng.run()
    teng.run()
    assert (teng.classifier.count, teng.reweight.count) == (4, 2)
    want_r = _assert_same_params(jeng, teng)
    assert any(float((want_r[k] - rw0[k]).abs().max()) > 0 for k in want_r)
    assert paths and set(paths) == {"_fwd_multi"}
    assert all(f.launches == 0 for f in tfa.KERNELS.values())


@pytest.mark.parametrize("hypergradient,solver_config", [
    ("cg", dict(cg_iterations=3)),
    ("neumann", dict(neumann_iterations=3)),
], ids=["cg", "neumann"])
def test_small_cg_neumann_run_matches_jax(hypergradient, solver_config):
    from betty_tpu_torch.ops import vector

    argv = [a for a in ARGV if a != "--flash"] + ["--hypergradient", hypergradient]
    _, jeng, teng = _engines(argv, use_fused_vector_ops=True, **solver_config)
    rw0 = {k: v.clone() for k, v in teng.states["reweight"]["params"].items()}
    jeng.run()
    teng.run()
    assert (teng.classifier.count, teng.reweight.count) == (4, 2)
    assert (jeng.classifier.count, jeng.reweight.count) == (4, 2)
    want_r = _assert_same_params(jeng, teng)
    assert any(float((want_r[k] - rw0[k]).abs().max()) > 0 for k in want_r)
    # on the CPU the fused loops took the kernels' plain versions
    assert vector.fused_dot2.launches == vector.cg_fused_step.launches == 0
    assert vector.neumann_fused_step.launches == 0
