"""The 3-level image-captioning NAS (IUC): the port's
``examples/nas_augmented_image_captioning_3_level.py`` and
``models/iuc.py`` against the JAX package's example.

* The ``Captioner`` (d 16, depth 1, 2 heads) with JAX's weights and
  projection injected through ``convert.from_flax_captioner``: logits,
  ``caption_loss`` and its gradients within 1e-10, ``greedy_decode``'s
  tokens equal; the program at ``tests/test_examples2.py``'s arguments
  for 8 inner1 steps in float64: parameters within 1e-8, counts 8:4:2, 3
  paths, every level moved, validation metrics equal
  (``torch_programs_impl.py captioner iuc``, in a subprocess).
* The schedule: the port's ``_Simulator`` and ``compress`` give JAX's
  events, period and segments; compiled blocks equal driver mode bit for
  bit on the CPU.
* ``inner2``'s pseudo-captions come from inner1's parameters in the bound
  context, not from the engine's states; the projection is a constant of
  the model, the same in every build and not part of the state.
* The CLI's defaults are the JAX example's; ``--data-dir`` reads a
  captions npz.
"""

from pathlib import Path
import dataclasses
import sys

import numpy as np
import pytest
import torch

from betty_tpu_torch import compile as tcompile
from betty_tpu_torch.examples import nas_augmented_image_captioning_3_level as tiuc
from betty_tpu_torch.problems.problem import ctx_replace
from betty_tpu_torch.utils import tree_map
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
CASES = ("captioner", "iuc")
SMALL = ["--device", "cpu", "--n", "64", "--batch", "8", "--seq_len", "6", "--vocab", "16",
         "--feat_dim", "8", "--dim", "16", "--depth", "1", "--heads", "2", "--valid_step", "1000"]

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def iuc_runs():
    return run_robust_impl(CASES, script="torch_programs_impl.py")


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(iuc_runs, case):
    lines = iuc_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def test_simulator_gives_jax_schedule():
    from betty_tpu import compile as jcompile

    sys.path.insert(0, str(ROOT / "tests"))
    from test_examples2 import load

    mod = load("nas_augmented_image_captioning_3_level")
    jeng = mod.build_engine(mod.parse_args(["--n", "64", "--batch", "8", "--seq_len", "6",
                                            "--vocab", "16", "--feat_dim", "8", "--dim", "16",
                                            "--depth", "1", "--heads", "2"]))
    teng = tiuc.build_engine(tiuc.parse_args(SMALL))
    jev, jperiod, jphase = jcompile._Simulator(jeng).run()
    tev, tperiod, tphase = tcompile._Simulator(teng).run()
    assert [dataclasses.asdict(e) for e in tev] == [dataclasses.asdict(e) for e in jev]
    assert (tperiod, tphase) == (jperiod, jphase) and tperiod == 4
    jprobs = {p.name: p for p in jeng.problems}
    tprobs = {p.name: p for p in teng.problems}
    seg = lambda segs: [(s.name, s.is_scan, len(s.events)) for s in segs]  # noqa: E731
    assert seg(tcompile.compress(tev, tprobs)) == seg(jcompile.compress(jev, jprobs))


def test_compiled_equals_driver_bit_for_bit():
    argv = SMALL + ["--train_iters", "16"]
    driver = tiuc.build_engine(tiuc.parse_args(argv))
    driver.run()
    compiled = tiuc.build_engine(tiuc.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.period == 4 and runner.periods_run >= 3
    assert [p.count for p in compiled.problems] == [p.count for p in driver.problems] == [4, 8, 16]
    equal_trees(driver.states, compiled.states)
    assert driver.validation() == compiled.validation()


def test_pseudo_captions_read_inner1_through_the_context():
    engine = tiuc.build_engine(tiuc.parse_args(SMALL + ["--train_iters", "0"]))
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    batch = engine.inner2._convert_batch(engine.inner2.train_data_loader[0][0])
    feats = batch[0]
    alphas = engine.states["outer"]["params"]["w"]
    seen = []
    greedy = tiuc.greedy_decode

    def record(apply_fn, *a):
        seen.append(greedy(apply_fn, *a))
        return seen[-1]

    tiuc.greedy_decode = record
    try:
        engine.inner2.eval_loss(ctx, batch, rng=0)
        other = tree_map(lambda t: t + 0.5 * torch.randn_like(t), ctx["inner1"]["params"])
        engine.inner2.eval_loss(ctx_replace(ctx, "inner1", other), batch, rng=0)
    finally:
        tiuc.greedy_decode = greedy
    assert seen[0].dtype == torch.int64 and seen[0].shape == (8, 6)
    assert (seen[0][:, 0] == tiuc.BOS).all()
    assert not torch.equal(seen[0], seen[1])  # the context's inner1, not the states'
    want = greedy(engine.inner1, feats, alphas, 6)
    assert torch.equal(seen[0], want)


def test_projection_is_a_model_constant_not_state():
    a = tiuc.build_engine(tiuc.parse_args(SMALL))
    b = tiuc.build_engine(tiuc.parse_args(SMALL))
    for engine in (a, b):
        for name in ("inner1", "inner2"):
            assert "proj" not in engine.states[name]["params"]
            assert engine.states[name]["extra"] == {}
    from betty_tpu_torch.models.iuc import Captioner

    m1, m2 = Captioner(16, 8, dim=16, depth=1, heads=2, seed=0), \
        Captioner(16, 8, dim=16, depth=1, heads=2, seed=3)
    assert torch.equal(m1.proj, m2.proj) and m1.proj.shape == (8, 64)
    assert "proj" not in m1.state_dict()


def test_cli_defaults_are_the_jax_example():
    ours = vars(tiuc.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "nas_augmented_image_captioning_3_level"
                              / "main.py")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device", "compile_blocks"}


def test_data_dir_reads_a_captions_npz(tmp_path):
    feats, caps = tiuc.make_caption_data(60, 7, 20, 10, seed=5)
    path = tmp_path / "captions.npz"
    np.savez(path, feats=feats, captions=caps.astype(np.int32))
    args = tiuc.parse_args(["--device", "cpu", "--batch", "8", "--dim", "16", "--depth", "1",
                            "--heads", "2", "--train_iters", "4", "--data-dir", str(path)])
    engine = tiuc.build_engine(args)
    assert (args.seq_len, args.vocab) == (7, int(caps.max()) + 1)
    assert len(engine.test_data[1]) == 4  # the held-out fifth of the last third
    engine.run()
    stats = engine.validation()
    assert 0.0 <= stats["caption_acc"] <= 100.0 and 0.0 <= stats["caption_exact"] <= 100.0
