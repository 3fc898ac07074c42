"""The whole slice: SAMA data reweighting of a small transformer with
``--flash``, run by the JAX example and by the port from the same initial
weights (moved across with ``betty_tpu_torch.convert``) on the same batches.
After 4 classifier steps and 2 reweight steps (unroll 2) the parameters of
both problems agree within 1e-4 in float32, and the graph's paths and the
step counts are the same.
"""

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


@pytest.mark.parametrize("hypergradient", ["sama", "darts"])
def test_small_reweighting_run_matches_jax(hypergradient):
    argv = ARGV + ["--hypergradient", hypergradient]
    jmod = _jax_example()
    jeng = jmod.build_engine(jmod.parse_args(argv))
    teng = tex.build_engine(tex.parse_args(argv + ["--device", "cpu"]))
    teng.states["classifier"]["params"] = convert.from_flax_transformer(
        _numpy(jeng.states["classifier"]["params"]))
    teng.states["reweight"]["params"] = convert.from_flax_mwn(
        _numpy(jeng.states["reweight"]["params"]))

    names = lambda paths: [[p.name for p in path] for path in paths]  # noqa: E731
    assert names(teng.reweight.paths) == names(jeng.reweight.paths) == [
        ["reweight", "classifier", "reweight"]]
    assert names(teng.classifier.paths) == names(jeng.classifier.paths) == []
    assert [p.name for p in teng.leaves] == [p.name for p in jeng.leaves] == ["classifier"]

    jeng.run()
    teng.run()
    assert (teng.classifier.count, teng.reweight.count) == (4, 2)
    assert (jeng.classifier.count, jeng.reweight.count) == (4, 2)

    want_c = convert.from_flax_transformer(_numpy(jeng.states["classifier"]["params"]))
    want_r = convert.from_flax_mwn(_numpy(jeng.states["reweight"]["params"]))
    for name, want in (("classifier", want_c), ("reweight", want_r)):
        got = teng.states[name]["params"]
        assert set(got) == set(want)
        for k in want:
            err = float((got[k] - want[k]).abs().max())
            assert err <= 1e-4, (name, k, err)
    # the reweighter really moved
    init_r = convert.from_flax_mwn(_numpy(jmod.build_engine(
        jmod.parse_args(argv)).states["reweight"]["params"]))
    assert any(float((want_r[k] - init_r[k]).abs().max()) > 0 for k in want_r)
