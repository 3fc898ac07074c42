"""Engine checkpoints of the port (``betty_tpu_torch/checkpoint.py``) on the
CPU.

* The four cases of ``tests/test_checkpoint.py`` on the port's
  logistic-regression HPO program: a round trip, a mid-epoch and
  mid-unroll resume under roll-back, an ``auto_resume`` restart and an ITD
  resume mid-unroll. Each resumed run equals the port's uninterrupted run
  bit for bit and is within 1e-6 of the JAX package's (float32).
* Compiled blocks: resumed compiled equals uninterrupted compiled and
  driver mode bit for bit (SAMA on a small transformer with dropout 0.1
  and a learning rate that changes after the cut; roll-back cut mid-unroll
  in the driver remainder; ITD cut at a block boundary, where no unroll is
  recorded).
* The Meta-Weight-Net program (BatchNorm, a MultiStepLR after the cut)
  resumed bit for bit, in driver mode and compiled.
* A save cut before ``meta.json`` is replaced restores the previous step; a
  checkpoint of another structure raises; the examples' ``--checkpoint_dir``
  round trip; ``Problem.state_dict`` / ``load_state_dict``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import betty_tpu
from betty_tpu.data import ArrayLoader as JArrayLoader
from betty_tpu.module import from_fn as jfrom_fn
from betty_tpu_torch import (Config, Engine, EngineConfig, ImplicitProblem, IterativeProblem,
                             optim)
from betty_tpu_torch import checkpoint as ckpt
from betty_tpu_torch.compile import _paths
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.examples import learning_to_reweight as mwn
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from betty_tpu_torch.module import from_fn
from fixtures import Inner as JInner, Outer as JOuter, child_module, make_data, make_engine
from fixtures import parent_module

TOL_JAX = 1e-6  # float32, the port against the JAX package after the same steps


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_states(a, b):
    """Every tensor and integer leaf of two engines' states equal."""
    assert set(a) == set(b)
    for name in a:
        pa, pb = dict(_paths(a[name])), dict(_paths(b[name]))
        assert set(pa) == set(pb), name
        for k, x in pa.items():
            if torch.is_tensor(x):
                assert torch.equal(x, pb[k]), (name, k)
            else:
                assert x == pb[k] and type(x) is type(pb[k]), (name, k, x, pb[k])


def _jax_err(port_w, jax_w):
    return float(np.max(np.abs(port_w.numpy() - np.asarray(jax_w))))


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def _hpo(inner_config, engine_config, loaders=False):
    """The port's logistic-regression HPO program: ``fixtures.make_engine``'s
    counterpart (one full batch a problem), or with ``loaders`` that of
    ``test_resume_exactness_midepoch_midunroll`` (160 examples in
    epoch-shuffled ``ArrayLoader``s of 16)."""
    train, valid = lr.make_data(seed=0, n=160 if loaders else 1000)
    if loaders:
        outer_data = ArrayLoader(*valid, batch_size=16, seed=1)
        inner_data = ArrayLoader(*train, batch_size=16, seed=0)
    else:
        outer_data, inner_data = [valid], [train]
    outer = lr.Outer(name="outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9), train_data_loader=outer_data,
                     config=Config())
    inner = lr.Inner(name="inner",
                     module=from_fn(lambda p, x: (x @ p["w"], p["w"]), {"w": torch.zeros(20)}),
                     optimizer=optim.sgd(lr=0.1), train_data_loader=inner_data,
                     config=inner_config)
    engine = Engine(config=engine_config, problems=[outer, inner],
                    dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                    device="cpu")
    return engine, outer, inner


def _jax_hpo(inner_config, engine_config):
    """JAX's program of ``test_resume_exactness_midepoch_midunroll``."""
    train, valid = make_data(n=160)
    outer = JOuter("outer", module=parent_module(),
                   optimizer=betty_tpu.optim.sgd(lr=1.0, momentum=0.9),
                   train_data_loader=JArrayLoader(np.asarray(valid[0]), np.asarray(valid[1]),
                                                  batch_size=16, seed=1),
                   config=betty_tpu.Config())
    inner = JInner("inner", module=child_module(), optimizer=betty_tpu.optim.sgd(lr=0.1),
                   train_data_loader=JArrayLoader(np.asarray(train[0]), np.asarray(train[1]),
                                                  batch_size=16, seed=0),
                   config=inner_config)
    engine = betty_tpu.Engine(config=engine_config, problems=[outer, inner],
                              dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}})
    return engine


def test_checkpoint_roundtrip(tmp_path):
    engine, _, inner = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=6))
    engine.run()
    inner.rng  # a host read of the step's random stream: live host state
    w_trained = engine.states["inner"]["params"]["w"].clone()
    engine.save_checkpoint(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "step_6.pt"]

    engine2, _, inner2 = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=6))
    engine2.load_checkpoint(str(tmp_path))
    assert engine2.global_step == 6 and inner2._count == 6
    assert (inner2._host_rng_calls, inner2._host_rng_last_count) == (1, 6)
    assert torch.equal(w_trained, engine2.states["inner"]["params"]["w"])
    _equal_states(engine.states, engine2.states)

    # training continues from the restored state, as the uninterrupted run
    engine2.train_iters = 2
    engine2.run()
    assert inner2._count == 8
    full, _, _ = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=8))
    full.run()
    _equal_states(full.states, engine2.states)

    jeng, _, _ = make_engine(betty_tpu.Config(unroll_steps=2),
                             betty_tpu.EngineConfig(train_iters=6))
    jeng.run()
    jeng.save_checkpoint(str(tmp_path / "jax"))
    jeng2, _, jinner2 = make_engine(betty_tpu.Config(unroll_steps=2),
                                    betty_tpu.EngineConfig(train_iters=6))
    jeng2.load_checkpoint(str(tmp_path / "jax"))
    jeng2.train_iters = 2
    jeng2.run()
    assert jinner2.count == inner2.count
    for name in ("inner", "outer"):
        assert _jax_err(engine2.states[name]["params"]["w"],
                        jeng2.states[name]["params"]["w"]) <= TOL_JAX


def test_resume_exactness_midepoch_midunroll(tmp_path):
    """14 iterations uninterrupted against 7 + a fresh engine's 7: five
    batches an epoch put the cut mid-epoch, and unroll 4 under roll_back
    puts it mid-unroll with a live roll-back cache."""
    def build(iters):
        return _hpo(Config(unroll_steps=4), EngineConfig(train_iters=iters, roll_back=True),
                    loaders=True)

    e_full, _, _ = build(14)
    e_full.run()

    e_a, _, i_a = build(7)
    e_a.run()
    assert i_a._state_cache is not None  # mid-unroll: the cache is live
    e_a.save_checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["rollback_cached"] == ["inner"] and meta["batches_served"]["inner"] == [2]

    e_b, _, i_b = build(14)
    e_b.load_checkpoint(str(tmp_path))
    assert i_b._count == 7 and not i_b._inner_loop_start and i_b._state_cache is not None
    for _ in range(7):
        e_b.global_step += 1
        e_b.train_step()
    _equal_states(e_full.states, e_b.states)

    jeng = _jax_hpo(betty_tpu.Config(unroll_steps=4),
                    betty_tpu.EngineConfig(train_iters=14, roll_back=True))
    jeng.run()
    for name in ("inner", "outer"):
        assert _jax_err(e_b.states[name]["params"]["w"],
                        jeng.states[name]["params"]["w"]) <= TOL_JAX


def test_auto_resume_elastic_restart(tmp_path):
    """``EngineConfig(auto_resume=True)``: a run cut after 6 iterations (last
    checkpoint at step 4) and started again with the same program (total
    14) restores step 4, runs the remaining 10 and ends where the
    uninterrupted run ends."""
    def build(iters, path=None, auto=False):
        engine, _, _ = _hpo(
            Config(unroll_steps=2),
            EngineConfig(train_iters=iters, checkpoint_dir=str(path) if path else None,
                         checkpoint_step=4 if path else 0, auto_resume=auto),
            loaders=True)
        return engine

    e_full = build(14)
    e_full.run()
    path = tmp_path / "ckpt"
    build(6, path).run()
    assert json.loads((path / "meta.json").read_text())["global_step"] == 4
    e_b = build(14, path, auto=True)
    e_b.run()
    assert e_b.global_step == 14 and e_b.train_iters == 10
    _equal_states(e_full.states, e_b.states)
    # the restarted run saved again on its own cadence
    assert json.loads((path / "meta.json").read_text())["global_step"] == 12
    assert sorted(os.listdir(path)) == ["meta.json", "step_12.pt"]


class _Meta(ImplicitProblem):
    def training_step(self, batch):
        x, y = batch
        return F.binary_cross_entropy_with_logits(self.adapt(x), y)


class _Adapt(IterativeProblem):
    def training_step(self, batch):
        x, y = batch
        return F.binary_cross_entropy_with_logits(self.module(x), y)

    def unroll_init(self, start_params):
        return self.meta.params  # MAML: differentiate to the meta-initialization


def _maml(iters, compiled=False, path=None, step=0, auto=False):
    """``test_itd_midunroll_checkpoint_resume``'s program in the port: an
    IterativeProblem (unroll 4, ArrayLoader) under a first_order=False
    parent."""
    train, valid = lr.make_data(seed=0, n=160)
    meta = _Meta("meta", module=from_fn(lambda p, x: x @ p["w"], {"w": torch.zeros(20)}),
                 optimizer=optim.sgd(lr=0.5),
                 train_data_loader=ArrayLoader(*valid, batch_size=16, seed=1),
                 config=Config(first_order=False))
    adapt = _Adapt("adapt", module=from_fn(lambda p, x: x @ p["w"], {"w": torch.zeros(20)}),
                   optimizer=optim.sgd(lr=0.1),
                   train_data_loader=ArrayLoader(*train, batch_size=16, seed=0),
                   config=Config(unroll_steps=4))
    engine = Engine(config=EngineConfig(train_iters=iters, compile_blocks=compiled,
                                        checkpoint_dir=str(path) if path else None,
                                        checkpoint_step=step, auto_resume=auto),
                    problems=[meta, adapt],
                    dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}}, device="cpu")
    return engine, meta, adapt


def test_itd_midunroll_checkpoint_resume(tmp_path):
    """A cut at 6 with unroll 4 leaves two recorded batches of the unroll:
    the start state and the batches are saved, and the parent's replay in
    the resumed engine equals the uninterrupted run's bit for bit."""
    e_full, _, _ = _maml(14)
    e_full.run()

    e_a, _, a_a = _maml(6)
    e_a.run()
    assert a_a._unroll_start_state is not None and len(a_a._unroll_batches) == 2
    e_a.save_checkpoint(str(tmp_path))
    assert json.loads((tmp_path / "meta.json").read_text())["unroll_recorded"] == {"adapt": 2}

    e_b, _, a_b = _maml(14)
    e_b.load_checkpoint(str(tmp_path))
    assert len(a_b._unroll_batches) == 2 and not a_b._pending_unroll_reset
    for got, want in zip(a_b._unroll_batches, a_a._unroll_batches):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for _ in range(8):
        e_b.global_step += 1
        e_b.train_step()
    _equal_states(e_full.states, e_b.states)

    class JMeta(betty_tpu.ImplicitProblem):
        def training_step(self, batch):
            x, y = batch
            return optax.sigmoid_binary_cross_entropy(self.adapt(x), y).mean()

    class JAdapt(betty_tpu.IterativeProblem):
        def training_step(self, batch):
            x, y = batch
            return optax.sigmoid_binary_cross_entropy(self.module(x), y).mean()

        def unroll_init(self, start_params):
            return self.meta.params

    train, valid = make_data(n=160)
    jmeta = JMeta("meta", module=jfrom_fn(lambda p, x: x @ p["w"], {"w": jnp.zeros(20)}),
                  optimizer=betty_tpu.optim.sgd(lr=0.5),
                  train_data_loader=JArrayLoader(np.asarray(valid[0]), np.asarray(valid[1]),
                                                 batch_size=16, seed=1),
                  config=betty_tpu.Config(first_order=False))
    jadapt = JAdapt("adapt", module=jfrom_fn(lambda p, x: x @ p["w"], {"w": jnp.zeros(20)}),
                    optimizer=betty_tpu.optim.sgd(lr=0.1),
                    train_data_loader=JArrayLoader(np.asarray(train[0]), np.asarray(train[1]),
                                                   batch_size=16, seed=0),
                    config=betty_tpu.Config(unroll_steps=4))
    jeng = betty_tpu.Engine(config=betty_tpu.EngineConfig(train_iters=14),
                            problems=[jmeta, jadapt],
                            dependencies={"u2l": {jmeta: [jadapt]}, "l2u": {jadapt: [jmeta]}})
    jeng.run()
    assert _jax_err(e_b.states["meta"]["params"]["w"],
                    jeng.states["meta"]["params"]["w"]) <= TOL_JAX


# ---------------------------------------------------------------------------
# compiled blocks
# ---------------------------------------------------------------------------

SAMA_ARGV = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len", "16",
             "--batch_size", "4", "--train_size", "48", "--meta_size", "16",
             "--precision", "fp32", "--dropout", "0.1", "--unroll_steps", "2",
             "--hypergradient", "sama", "--flash", "--device_data", "--device", "cpu"]


def _sama(iters, compiled, path=None, auto=False):
    engine = tex.build_engine(tex.parse_args(
        SAMA_ARGV + ["--train_iters", str(iters)] + (["--compile_blocks"] if compiled else [])))
    # the learning rate halves every 5 steps: it changes after the cut at 6
    engine.classifier.optimizer.schedule = optim.step_lr(2e-5, step_size=5, gamma=0.5)
    if path is not None:
        engine.config.checkpoint_dir, engine.config.checkpoint_step = str(path), 6
        engine.config.auto_resume = auto
    return engine


def test_sama_dropout_resumed_compiled_equals_uninterrupted_and_driver(tmp_path):
    """SAMA with dropout 0.1 and Adam on a small transformer, data on the
    device: 6 iterations as one compiled block of 3 periods, a checkpoint at
    that block boundary, and a fresh engine resumed by ``auto_resume`` to 12
    (a new runner, a new warm-up and capture; the seeds, bias corrections
    and learning rates continue from the restored counts). Equal bit for bit
    to 12 iterations compiled and in driver mode."""
    driver = _sama(12, False)
    driver.run()
    full = _sama(12, True)
    full.run()
    _equal_states(driver.states, full.states)

    cut = _sama(6, True, tmp_path)
    cut.run()
    assert cut.block_runner.periods_run == 3 and cut.block_runner.finalized
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["global_step"] == 6 and meta["counts"] == {"reweight": 3, "classifier": 6}
    assert meta["batches_served"]["classifier"] == [6]
    resumed = _sama(12, True, tmp_path, auto=True)
    resumed.run()
    runner = resumed.block_runner
    assert runner.periods_run == 3 and runner.capture_seconds is not None
    assert resumed.classifier.count == 12 and resumed.classifier.optimizer.schedule(11) != \
        resumed.classifier.optimizer.schedule(5)
    _equal_states(full.states, resumed.states)
    assert resumed.classifier.batches_served == full.classifier.batches_served
    assert resumed.classifier.epoch_counter == full.classifier.epoch_counter


def test_rollback_compiled_resume_mid_unroll(tmp_path):
    """Roll-back under compiled blocks (unroll 4): 10 iterations are two
    blocks and two driver steps, so the checkpoint at 10 is mid-unroll with
    the cache the blocks handed back; the resumed compiled run (driver
    warm-up to the block phase, then blocks) equals 20 uninterrupted
    iterations compiled and in driver mode."""
    def build(iters, compiled, auto=False):
        engine, _, inner = _hpo(
            Config(unroll_steps=4),
            EngineConfig(train_iters=iters, roll_back=True, compile_blocks=compiled,
                         checkpoint_dir=str(tmp_path), checkpoint_step=10, auto_resume=auto),
            loaders=True)
        return engine, inner

    driver, _ = build(20, False)
    driver.config.checkpoint_step = 0
    driver.run()
    full, _ = build(20, True)
    full.config.checkpoint_step = 0
    full.run()
    _equal_states(driver.states, full.states)

    cut, inner = build(10, True)
    cut.run()
    assert cut.block_runner.periods_run == 2 and inner._state_cache is not None
    assert json.loads((tmp_path / "meta.json").read_text())["rollback_cached"] == ["inner"]
    resumed, inner = build(20, True, auto=True)
    resumed.run()
    assert resumed.block_runner.periods_run == 2 and inner.count == 20
    _equal_states(full.states, resumed.states)


def test_itd_block_boundary_records_no_unroll(tmp_path):
    """At a compiled-block boundary every unroll of an ITD child lies inside
    a finished block: the child stands at an unroll start, the save writes
    no recording (and the runner's caches are empty), and the resumed
    compiled run equals the uninterrupted one and driver mode bit for
    bit."""
    driver, _, _ = _maml(16)
    driver.run()
    full, _, _ = _maml(16, compiled=True)
    full.run()
    _equal_states(driver.states, full.states)

    saved = []
    cut, _, adapt = _maml(8, compiled=True, path=tmp_path, step=8)
    orig = cut.save_checkpoint

    def save(path):
        saved.append((cut.block_runner.live, adapt._inner_loop_start, len(adapt._unroll_batches)))
        orig(path)

    cut.save_checkpoint = save
    cut.run()
    # the save ran between blocks, with the runner live and the child at an
    # unroll start; the blocks record each unroll inside the period
    assert saved == [(True, True, 0)]
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["global_step"] == 8 and "unroll_recorded" not in meta
    assert meta["rollback_cached"] == [] and meta["inner_loop_start"]["adapt"]
    resumed, _, _ = _maml(16, compiled=True, path=tmp_path, step=8, auto=True)
    resumed.run()
    assert resumed.block_runner.periods_run == 2
    _equal_states(full.states, resumed.states)


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
def test_mwn_batchnorm_multistep_resume(tmp_path, compiled):
    """The Meta-Weight-Net program (3-block ResNet with BatchNorm, SGD with
    nesterov momentum under a MultiStepLR whose milestone falls after the
    cut, Adam reweighter, darts), cut at 3 of 6 and resumed by
    ``auto_resume``: params, batch statistics and optimizer state equal the
    uninterrupted run's bit for bit."""
    def build(iters, auto=False):
        argv = ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
                "--train_size", "64", "--meta_size", "32", "--train_iters", str(iters),
                "--lr_milestones", "4", "--device_data"]
        engine = mwn.build_engine(mwn.parse_args(argv + (["--compile_blocks"] if compiled
                                                         else [])))
        engine.config.checkpoint_dir, engine.config.checkpoint_step = str(tmp_path), 3
        engine.config.auto_resume = auto
        engine.config.block_periods = 1
        return engine

    full = build(6)
    full.config.checkpoint_step = 0
    full.run()
    build(3).run()
    resumed = build(6, auto=True)
    resumed.run()
    assert resumed.classifier.count == 6
    assert any(k == ("batch_stats",) or k[0] == "batch_stats"
               for k, _ in _paths(resumed.states["classifier"]["extra"]))
    _equal_states(full.states, resumed.states)


# ---------------------------------------------------------------------------
# faults and boundaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", ["tensor_file", "meta"])
def test_cut_save_restores_the_previous_step(tmp_path, monkeypatch, cut):
    """A save cut while writing the tensor file or ``meta.json`` leaves the
    previous checkpoint whole: ``meta.json`` still names step 2, whose file
    is there, and it restores."""
    engine, _, _ = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=2))
    engine.run()
    engine.save_checkpoint(str(tmp_path))
    w2 = engine.states["inner"]["params"]["w"].clone()
    engine.train_iters = 2
    engine.run()
    assert engine.global_step == 4

    class Cut(Exception):
        pass

    def fail(*args, **kwargs):
        raise Cut()

    if cut == "meta":
        def dump(obj, f):  # a partial write, then the process dies
            f.write(json.dumps(obj)[:20])
            raise Cut()
        monkeypatch.setattr(ckpt.json, "dump", dump)
    else:
        monkeypatch.setattr(ckpt.torch, "save", fail)
    with pytest.raises(Cut):
        engine.save_checkpoint(str(tmp_path))
    monkeypatch.undo()
    assert json.loads((tmp_path / "meta.json").read_text())["global_step"] == 2
    assert (tmp_path / "step_2.pt").exists()

    fresh, _, inner = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=2))
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_step == 2 and inner.count == 2
    assert torch.equal(fresh.states["inner"]["params"]["w"], w2)


def test_mismatched_structure_raises(tmp_path):
    """A checkpoint of a problem with another optimizer (momentum adds a
    trace) or another parameter shape raises, naming both structures."""
    engine, _, _ = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=2))
    engine.run()
    engine.save_checkpoint(str(tmp_path))
    other, _, inner = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=2))
    other.problems[0].optimizer = optim.sgd(lr=1.0)
    other.states["outer"]["opt_state"] = {}
    with pytest.raises(ValueError, match="current: .*\n  checkpoint: .*'trace'"):
        other.load_checkpoint(str(tmp_path))
    state = inner.state_dict()
    state["params"]["w"] = torch.zeros(21)
    with pytest.raises(ValueError, match=r"(?s)load_state_dict for problem 'inner'.*float32\[21\]"):
        inner.load_state_dict(state)


def test_state_dict_roundtrip_keeps_integer_leaves():
    """``state_dict`` hands out host copies with Adam's ``count`` and
    ``sched_step`` as integers; ``load_state_dict`` puts them back in the
    dtype of the tensors they replace (a float64 copy comes back float32)."""
    def build():
        engine, _, inner = _hpo(Config(unroll_steps=2), EngineConfig(train_iters=4))
        inner.optimizer = optim.adam(lr=0.05)
        engine.states["inner"] = inner.init_state()
        return engine, inner

    a, inner_a = build()
    a.run()
    sd = inner_a.state_dict()
    assert sd["opt_state"]["count"] == 4 and type(sd["opt_state"]["count"]) is int
    assert type(sd["sched_step"]) is int
    assert sd["params"]["w"].data_ptr() != a.states["inner"]["params"]["w"].data_ptr()
    b, inner_b = build()
    inner_b.load_state_dict({**sd, "params": {"w": sd["params"]["w"].double()}})
    assert b.states["inner"]["params"]["w"].dtype == torch.float32
    _equal_states({"inner": a.states["inner"]}, {"inner": b.states["inner"]})


def test_examples_checkpoint_dir_roundtrip(tmp_path):
    """``--checkpoint_dir`` of both examples saves on each improvement of
    the validation accuracy (a test or dev set given to the engine); a
    fresh engine loads the last save and holds the state of that step."""
    # MWN: a 3-block ResNet with a small synthetic test set
    argv = ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
            "--train_size", "64", "--meta_size", "32", "--train_iters", "6", "--valid_step",
            "2", "--checkpoint_dir", str(tmp_path / "mwn")]
    x, y = mwn.make_synthetic_cifar(16, seed=3)
    # BERT: the small transformer with a synthetic dev split
    targv = SAMA_ARGV + ["--train_iters", "6", "--valid_step", "2",
                         "--checkpoint_dir", str(tmp_path / "bert")]
    dev = tex.make_synthetic_sst2(16, 16, 1000, seed=2, imbalance=1)
    for ex, args, data, attr in ((mwn, argv, (x, y), "test_data"),
                                 (tex, targv, dev, "dev_data")):
        engine = ex.build_engine(ex.parse_args(args))
        setattr(engine, attr, data)
        saves = []
        orig = engine.save_checkpoint

        def save(path, _engine=engine, _orig=orig):
            saves.append((_engine.global_step, {n: {k: t.clone() for k, t in
                                                    s["params"].items()}
                                                for n, s in _engine.states.items()}))
            _orig(path)

        engine.save_checkpoint = save
        engine.run()
        assert saves and saves[0][0] == 2, [s[0] for s in saves]
        fresh = ex.build_engine(ex.parse_args(args))
        fresh.load_checkpoint(args[args.index("--checkpoint_dir") + 1])
        step, params = saves[-1]
        assert fresh.global_step == step
        for name, ps in params.items():
            assert all(torch.equal(t, fresh.states[name]["params"][k]) for k, t in ps.items())
