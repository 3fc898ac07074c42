"""Compiled blocks of the port (``betty_tpu_torch/compile.py``) against
driver mode and against the JAX package's compiled blocks, on the CPU.

* The schedule: the port's ``_Simulator`` and ``compress`` give JAX's
  events, period, initial phase and segments on the same graphs.
* The loader cursor API gives JAX's index rows across an epoch rollover.
* The cases of ``tests/test_compile.py`` (meshes aside) on the
  logistic-regression HPO program: port compiled equals port driver bit
  for bit and is within 1e-6 of JAX compiled; the ITD MAML case of
  ``test_block_itd_maml`` likewise.
* Small reweighting runs (transformer SAMA with dropout and Adam, a
  3-block ResNet MWN with a step schedule): compiled equals driver bit for
  bit, and the seeds, bias corrections and learning rates the runner
  writes before each period are the values driver mode used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betty_tpu
import betty_tpu_torch
from betty_tpu import compile as jcompile
from betty_tpu.data import ArrayLoader as JArrayLoader
from betty_tpu.module import from_fn as jfrom_fn
from betty_tpu_torch import (Config, Engine, EngineConfig, ImplicitProblem, IterativeProblem,
                             optim, utils)
from betty_tpu_torch import compile as tcompile
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.examples import learning_to_reweight as mwn
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from betty_tpu_torch.module import from_fn
from fixtures import make_engine


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores, and
    small ops spread over every core wait for all of them (a hundred times
    slower on a loaded machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


class _JLevel(betty_tpu.ImplicitProblem):
    def training_step(self, batch):
        return jnp.sum(self.module() * batch)


class _TLevel(ImplicitProblem):
    def training_step(self, batch):
        return torch.sum(self.module() * batch)


def _graph(names, unrolls, chain, roll_back=False, gas=1, warmup=0, jax_side=True):
    """A chain of problems ``names[0]`` (top) ... ``names[-1]`` (leaf) with
    the given unrolls; ``chain`` False: every lower problem hangs off the
    top one."""
    if jax_side:
        cls, mod, opt, E, EC, C = (_JLevel, lambda: jfrom_fn(lambda p: p["w"],
                                                             {"w": jnp.zeros(2)}),
                                   betty_tpu.optim.sgd, betty_tpu.Engine,
                                   betty_tpu.EngineConfig, betty_tpu.Config)
        data = [np.ones(2, np.float32)]
    else:
        cls, mod, opt, E, EC, C = (_TLevel, lambda: from_fn(lambda p: p["w"],
                                                            {"w": torch.zeros(2)}),
                                   optim.sgd, Engine, EngineConfig, Config)
        data = [torch.ones(2)]
    probs = [cls(n, module=mod(), optimizer=opt(lr=0.1), train_data_loader=data,
                 config=C(unroll_steps=u, gradient_accumulation=gas, warmup_steps=warmup))
             for n, u in zip(names, unrolls)]
    u2l, l2u = {}, {}
    for i in range(1, len(probs)):
        upper = probs[i - 1] if chain else probs[0]
        u2l.setdefault(upper, []).append(probs[i])
        l2u.setdefault(probs[i], []).append(upper)
    kw = {} if jax_side else {"device": "cpu"}
    return E(config=EC(train_iters=1, roll_back=roll_back), problems=probs,
             dependencies={"u2l": u2l, "l2u": l2u}, **kw)


SCHEDULES = {
    "bilevel_unroll20": dict(names=["outer", "inner"], unrolls=[1, 20], chain=True),
    "rollback_unroll10": dict(names=["outer", "inner"], unrolls=[1, 10], chain=True,
                              roll_back=True),
    "gas2": dict(names=["outer", "inner"], unrolls=[1, 4], chain=True, gas=2),
    "warmup5": dict(names=["outer", "inner"], unrolls=[1, 2], chain=True, warmup=5),
    "trilevel_uneven": dict(names=["a", "b", "c"], unrolls=[1, 2, 3], chain=True),
    "trilevel_rollback": dict(names=["a", "b", "c"], unrolls=[1, 3, 2], chain=True,
                              roll_back=True),
    "fan_in": dict(names=["top", "left", "right"], unrolls=[2, 3, 2], chain=False),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_simulator_gives_jax_events_period_and_phase(schedule):
    spec = SCHEDULES[schedule]
    jeng = _graph(**spec)
    teng = _graph(**spec, jax_side=False)
    jev, jperiod, jphase = jcompile._Simulator(jeng).run()
    tev, tperiod, tphase = tcompile._Simulator(teng).run()
    assert [dataclasses.asdict(e) for e in tev] == [dataclasses.asdict(e) for e in jev]
    assert (tperiod, tphase) == (jperiod, jphase)
    jprobs = {p.name: p for p in jeng.problems}
    tprobs = {p.name: p for p in teng.problems}
    seg = lambda segs: [(s.name, s.is_scan, len(s.events)) for s in segs]  # noqa: E731
    assert seg(tcompile.compress(tev, tprobs)) == seg(jcompile.compress(jev, jprobs))
    # the runner's marks of the recovers that find their cache in the period
    jr = jcompile.BlockRunner(jeng, scan_periods=1)
    tr = tcompile.BlockRunner(teng)
    assert [e.cache_sure for e in tr.events] == [e.cache_sure for e in jr.events]
    assert tr.count_delta == jr.count_delta and tr.period == jr.period


# ---------------------------------------------------------------------------
# the loader cursor
# ---------------------------------------------------------------------------


def test_loader_cursor_gives_jax_index_rows_across_an_epoch_rollover():
    x = np.arange(50 * 3).reshape(50, 3).astype(np.float32)
    y = np.arange(50).astype(np.int32)
    ours = ArrayLoader(x, y, batch_size=8, seed=3, device="cpu")
    theirs = JArrayLoader(x, y, batch_size=8, seed=3)
    for a, b in ((ours, theirs),):
        a.sync_cursor(1, 4)
        b.sync_cursor(1, 4)
    rows = ours.take_indices(5)  # 2 left in epoch 1, then 3 of epoch 2
    assert rows.dtype == np.int64 and rows.shape == (5, 8)
    assert np.array_equal(rows, theirs.take_indices(5))
    assert ours.cursor_position() == theirs.cursor_position() == (2, 3)
    assert np.array_equal(ours.take_indices(9), theirs.take_indices(9))  # into epoch 4
    epoch, served = ours.cursor_position()
    assert (epoch, served) == theirs.cursor_position()
    got = [tuple(np.asarray(t) for t in b) for b in ours.iter_from(epoch, served)]
    want = [tuple(np.asarray(t) for t in b) for b in theirs.iter_from(epoch, served)]
    assert len(got) == len(want) == 6 - served
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    # a fresh cursor starts at the loader's epoch
    fresh = ArrayLoader(x, y, batch_size=8, seed=3)
    fresh.set_epoch(2)
    jfresh = JArrayLoader(x, y, batch_size=8, seed=3)
    jfresh.set_epoch(2)
    assert fresh.cursor_position() == jfresh.cursor_position() == (2, 0)
    assert np.array_equal(fresh.take_indices(7), jfresh.take_indices(7))


# ---------------------------------------------------------------------------
# the cases of tests/test_compile.py on the logistic-regression HPO program
# ---------------------------------------------------------------------------


def _port_engine(inner_config, engine_config, engine_cls=Engine):
    """The port's counterpart of ``fixtures.make_engine``."""
    train, valid = lr.make_data(seed=0)
    outer = lr.Outer(name="outer",
                     module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9), train_data_loader=[valid],
                     config=Config())
    inner = lr.Inner(name="inner",
                     module=from_fn(lambda p, x: (x @ p["w"], p["w"]), {"w": torch.zeros(20)}),
                     optimizer=optim.sgd(lr=0.1), train_data_loader=[train],
                     config=inner_config)
    engine = engine_cls(config=engine_config, problems=[outer, inner],
                        dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                        device="cpu")
    return engine, outer, inner


CASES = {  # name: (inner Config fields, EngineConfig fields)
    "matches_driver": (dict(unroll_steps=20), dict(train_iters=200)),
    "rollback": (dict(unroll_steps=10), dict(train_iters=60, roll_back=True)),
    "gas": (dict(unroll_steps=4, gradient_accumulation=2), dict(train_iters=32)),
    "remainder_driver_fallback": (dict(unroll_steps=10), dict(train_iters=25)),
    "warmup_driver_handoff": (dict(unroll_steps=2, warmup_steps=5), dict(train_iters=30)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_blocks_equal_driver_and_jax(case):
    inner_cfg, engine_cfg = CASES[case]
    runs = {}
    for compiled in (False, True):
        runs[compiled] = _port_engine(Config(**inner_cfg),
                                      EngineConfig(compile_blocks=compiled, **engine_cfg))
        runs[compiled][0].run()
    (e1, o1, i1), (e2, o2, i2) = runs[False], runs[True]
    assert e2.block_runner is not None and e2.block_runner.periods_run > 0
    assert (i1.count, o1.count) == (i2.count, o2.count)
    assert i2.count == engine_cfg["train_iters"]
    for name in ("inner", "outer"):
        assert torch.equal(e1.states[name]["params"]["w"], e2.states[name]["params"]["w"]), name
    jeng, _, jinner = make_engine(betty_tpu.Config(**inner_cfg),
                                  betty_tpu.EngineConfig(compile_blocks=True, **engine_cfg))
    jeng.run()
    assert jinner.count == i2.count
    for name in ("inner", "outer"):
        err = np.max(np.abs(e2.states[name]["params"]["w"].numpy()
                            - np.asarray(jeng.states[name]["params"]["w"])))
        assert err <= 1e-6, (name, err)


class _JMeta(betty_tpu.ImplicitProblem):
    def training_step(self, batch):
        return 0.5 * jnp.sum((self.adapt.params["w"] - batch) ** 2)


class _JAdapt(betty_tpu.IterativeProblem):
    def training_step(self, batch):
        return 0.5 * jnp.sum((self.module() - batch) ** 2)

    def on_inner_loop_start(self):
        self.set_params({"w": self.meta.params["w"]})

    def unroll_init(self, start_params):
        return {"w": self.meta.params["w"]}


class _TMeta(ImplicitProblem):
    def training_step(self, batch):
        return 0.5 * torch.sum((self.adapt.params["w"] - batch) ** 2)


class _TAdapt(IterativeProblem):
    def training_step(self, batch):
        return 0.5 * torch.sum((self.module() - batch) ** 2)

    def on_inner_loop_start(self):
        self.set_params({"w": self.meta.params["w"]})

    def unroll_init(self, start_params):
        return {"w": self.meta.params["w"]}


@pytest.mark.parametrize("case", ["plain", "rollback_gas2"])
def test_block_itd_maml_equals_driver_and_jax(case):
    """``tests/test_compile.py::test_block_itd_maml``: an IterativeProblem
    (MAML, the inner init coupled to the meta parameters) under a
    first_order=False parent, compiled: equal to driver mode bit for bit
    and within 1e-6 of JAX's compiled run; also with roll_back, two
    accumulated micro-batches a step, momentum and two inner batches."""
    D, STEPS = 4, 3
    rng = np.random.RandomState(5)
    t_in, t_out, th0 = (rng.randn(D).astype(np.float32) for _ in range(3))
    gas, roll_back = (2, True) if case == "rollback_gas2" else (1, False)
    momentum = 0.9 if roll_back else 0.0
    inner_data = [t_in, t_out] if roll_back else [t_in]

    def build(side, compiled):
        if side == "jax":
            M, A, ff, arr, pkg, kw = _JMeta, _JAdapt, jfrom_fn, jnp.asarray, betty_tpu, {}
        else:
            M, A, ff, arr = _TMeta, _TAdapt, from_fn, torch.as_tensor
            pkg, kw = betty_tpu_torch, {"device": "cpu"}
        meta = M("meta", module=ff(lambda p: p["w"], {"w": arr(th0)}),
                 optimizer=pkg.optim.sgd(lr=0.5), train_data_loader=[arr(t_out)],
                 config=pkg.Config(first_order=False))
        adapt = A("adapt", module=ff(lambda p: p["w"], {"w": arr(np.zeros(D, np.float32))}),
                  optimizer=pkg.optim.sgd(lr=0.1, momentum=momentum),
                  train_data_loader=[arr(t) for t in inner_data],
                  config=pkg.Config(unroll_steps=STEPS, gradient_accumulation=gas))
        engine = pkg.Engine(config=pkg.EngineConfig(train_iters=4 * STEPS * gas,
                                                    compile_blocks=compiled,
                                                    roll_back=roll_back),
                            problems=[meta, adapt],
                            dependencies={"u2l": {meta: [adapt]}, "l2u": {adapt: [meta]}}, **kw)
        engine.run()
        return engine

    driver, compiled = build("torch", False), build("torch", True)
    assert compiled.block_runner.periods_run == 4 and compiled.block_runner.itd_names == {"adapt"}
    for name in ("meta", "adapt"):
        assert torch.equal(driver.states[name]["params"]["w"],
                           compiled.states[name]["params"]["w"]), name
    jeng = build("jax", True)
    for name in ("meta", "adapt"):
        err = np.max(np.abs(compiled.states[name]["params"]["w"].numpy()
                            - np.asarray(jeng.states[name]["params"]["w"])))
        assert err <= 1e-6, (name, err)
    assert not torch.equal(compiled.states["meta"]["params"]["w"], torch.as_tensor(th0))


def test_compiled_blocks_validation_call_count_matches_driver():
    calls = []

    class ValEngine(Engine):
        def validation(self):
            calls.append(self.global_step)
            return {"metric": 0.0}

    def count(compiled):
        calls.clear()
        engine, _, _ = _port_engine(
            Config(unroll_steps=2),
            EngineConfig(train_iters=60, valid_step=7, compile_blocks=compiled,
                         block_periods=50), engine_cls=ValEngine)
        engine.run()
        return list(calls), engine

    driver, _ = count(False)
    block, engine = count(True)
    assert len(driver) == len(block) == 60 // 7, (driver, block)
    assert engine.block_runner.periods == 3  # capped by the cadence: 7 // 2


def test_compiled_blocks_regression_gate():
    engine, outer, _ = _port_engine(Config(unroll_steps=100),
                                    EngineConfig(train_iters=2000, compile_blocks=True))
    engine.run()
    assert engine.block_runner.periods_run == 20
    assert lr.final_outer_loss(engine, outer) < 0.48


def test_compiled_blocks_fall_back_to_driver_mode_without_a_schedule(monkeypatch, caplog):
    """No periodic schedule: the same log line as JAX, then driver mode."""
    monkeypatch.setattr(tcompile._Simulator, "MAX_ITERS", 1)
    engine, _, inner = _port_engine(Config(unroll_steps=5),
                                    EngineConfig(train_iters=12, compile_blocks=True))
    messages = []
    monkeypatch.setattr(engine.logger, "info", messages.append)
    engine.run()
    assert inner.count == 12 and engine.block_runner is None
    assert any(m.startswith("[compile_blocks] falling back to driver mode: Could not find a "
                            "periodic schedule") for m in messages), messages


# ---------------------------------------------------------------------------
# reweighting runs with dropout, Adam and a learning-rate schedule
# ---------------------------------------------------------------------------

SMALL_ARGV = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len", "16",
              "--batch_size", "4", "--train_size", "48", "--meta_size", "16",
              "--precision", "fp32", "--dropout", "0.1", "--unroll_steps", "2",
              "--train_iters", "10", "--hypergradient", "sama", "--flash",
              "--device", "cpu"]


def _reweighting_engine(compiled, device_data):
    argv = SMALL_ARGV + (["--compile_blocks"] if compiled else []) + \
        (["--device_data"] if device_data else [])
    engine = tex.build_engine(tex.parse_args(argv))
    # a schedule that changes within the run: learning rates are per-step values
    engine.classifier.optimizer.schedule = optim.step_lr(2e-5, step_size=3, gamma=0.5)
    engine.config.block_periods = 2
    return engine


@pytest.mark.parametrize("device_data", [False, True], ids=["host_loader", "device_loader"])
def test_sama_dropout_run_compiled_equals_driver(monkeypatch, device_data):
    driver = _reweighting_engine(False, device_data)
    record = tcompile._StepValues()  # makes the values as driver mode does, and lists them
    with utils.step_values(record):
        driver.run()

    written = []
    orig = tcompile._Slots.write

    def spy(self, r):
        out = orig(self, r)
        written.append(out)
        return out

    monkeypatch.setattr(tcompile._Slots, "write", spy)
    compiled = _reweighting_engine(True, device_data)
    compiled.run()
    runner = compiled.block_runner
    # 2 blocks of 2 periods, then 2 iterations in driver mode
    assert runner.period == 2 and runner.periods_run == 4 and len(written) == 4
    assert set(runner.fastpath) == ({"classifier", "reweight"} if device_data else set())

    # the values written before each period are the ones driver mode read
    values = [v for _, vals, _ in written for v in vals]
    seeds = [s for _, _, ss in written for s in ss]
    assert values == [fn(n) for fn, n, _ in record.scalars][:len(values)]
    assert seeds == [int(s) for s in record.seeds][:len(seeds)]
    # every dropout forward of a period draws anew in the next one (within a
    # period the solver's re-evaluations replay their step's seed)
    assert len(written[0][2]) > 0
    assert all(a != b for r in range(3) for a, b in zip(written[r][2], written[r + 1][2]))
    lrs = {fn(n) for fn, n, _ in record.scalars if fn is driver.classifier.optimizer.schedule}
    assert len(lrs) > 1, "the schedule did not change within the run"

    for name in ("classifier", "reweight"):
        for coll in ("params", "grad_acc", "last_grad"):
            a, b = driver.states[name].get(coll, {}), compiled.states[name].get(coll, {})
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (name, coll, k)
        mu, nu = driver.states[name]["opt_state"]["mu"], compiled.states[name]["opt_state"]["mu"]
        assert all(torch.equal(mu[k], nu[k]) for k in mu)
        assert driver.states[name]["opt_state"]["count"] == \
            compiled.states[name]["opt_state"]["count"]
        assert driver.states[name]["sched_step"] == compiled.states[name]["sched_step"]
    assert driver.classifier.count == compiled.classifier.count == 10
    assert driver.classifier.batches_served == compiled.classifier.batches_served
    assert driver.classifier.epoch_counter == compiled.classifier.epoch_counter


def test_mwn_run_compiled_equals_driver():
    """The Meta-Weight-Net program (3-block ResNet with BatchNorm, SGD with
    nesterov momentum under a MultiStepLR, Adam reweighter, darts): compiled
    equals driver bit for bit, running statistics included."""
    argv = ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
            "--train_size", "64", "--meta_size", "32", "--train_iters", "6",
            "--lr_milestones", "3", "--device_data"]
    engines = [mwn.build_engine(mwn.parse_args(argv + extra)) for extra in
               ([], ["--compile_blocks"])]
    for engine in engines:
        engine.run()
    driver, compiled = engines
    assert compiled.block_runner.periods_run == 6
    for name in ("classifier", "reweight"):
        for coll in ("params", "extra"):
            a = dict(tcompile._paths(driver.states[name][coll]))
            b = dict(tcompile._paths(compiled.states[name][coll]))
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a), (name, coll)


@pytest.mark.parametrize("variant,unroll", [("itd", 1), ("itd", 3), ("reinforce", 1)])
def test_mwn_itd_and_reinforce_runs_compiled_equal_driver(variant, unroll):
    """The MWN program (3-block ResNet, BatchNorm, a MultiStepLR milestone
    inside the run) differentiated through the classifier's unroll
    (``IterativeProblem``) or reweighted by ``reinforce``, built as
    ``chip_smoke.py`` builds them: compiled equals driver bit for bit,
    running statistics included, and the ITD replay runs inside the
    period."""
    import chip_smoke

    argv = ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
            "--train_size", "64", "--meta_size", "32", "--train_iters", str(4 * unroll),
            "--unroll_steps", str(unroll), "--lr_milestones", "2", "--device_data"]
    engines = [chip_smoke.mwn_variant(argv + extra, variant) for extra in
               ([], ["--compile_blocks"])]
    for engine in engines:
        engine.config.block_periods = 1
        engine.run()
    driver, compiled = engines
    runner = compiled.block_runner
    assert runner.periods_run == 4 and runner.itd_names == (
        {"classifier"} if variant == "itd" else set())
    assert (compiled.classifier.count, compiled.reweight.count) == (4 * unroll, 4)
    for name in ("classifier", "reweight"):
        for coll in ("params", "extra"):
            a = dict(tcompile._paths(driver.states[name][coll]))
            b = dict(tcompile._paths(compiled.states[name][coll]))
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a), (name, coll)


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
def test_profile_dir_writes_a_trace(tmp_path, compiled):
    """``EngineConfig.profile_dir``: the run is recorded under
    ``torch.profiler`` and its trace lands there, in driver mode and
    around the compiled blocks alike."""
    import json

    engine, _, inner = _port_engine(Config(unroll_steps=5),
                                    EngineConfig(train_iters=20, compile_blocks=compiled,
                                                 profile_dir=str(tmp_path / "trace")))
    engine.run()
    assert inner.count == 20
    assert (engine.block_runner is not None) == compiled
    files = sorted((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names or "aten::mv" in names, sorted(names)[:40]


def test_compiled_blocks_do_not_fall_back_on_a_failing_period(monkeypatch):
    """A period that fails raises; the run does not go on in driver mode."""
    engine, _, _ = _port_engine(Config(unroll_steps=5),
                                EngineConfig(train_iters=20, compile_blocks=True))

    def broken(self, *a, **kw):
        raise RuntimeError("period failed")

    monkeypatch.setattr(tcompile.BlockRunner, "_period", broken)
    with pytest.raises(RuntimeError, match="period failed"):
        engine.run()
