"""State donation of the port (``EngineConfig(donate_state=True)``,
``--donate``) on the CPU: every state leaf an update replaces is written
into its own storage, in driver mode and compiled blocks, with the values
of ``donate_state=False`` bit for bit.

* ``Optimizer.update_`` against ``update`` (the optimizers of
  ``tests/test_torch_optim.py``, a scheduled learning rate, param groups):
  bit for bit in float32 and float64, the parameters and moments in their
  own storage.
* Donated against undonated, bit for bit, in driver mode and compiled, in
  float32 and float64: the small north star (SAMA, Adam under a step
  schedule, two accumulation steps; bf16 steps in float32), the MWN
  program (SGD with nesterov momentum, BatchNorm statistics in ``extra``,
  a MultiStepLR), CG and Neumann, ImageNet pruning (an EMA teacher moved by
  ``param_callback``, two accumulation steps), learning by ignoring
  (per-group optimizers) and a program of hooks (gradient clipping,
  ``grad_callback``, ``custom_optimizer_step``, a ``param_callback``
  editing the other problem, ``set_params`` in ``on_inner_loop_start``;
  SAMA's ``last_grad``). Under donation every ``params``, ``opt_state``,
  ``grad_acc``, ``last_grad`` and ``extra`` leaf keeps its storage after
  every step and block; without it they move.
* JAX's exclusion rule: with a roll-back problem or an ITD child no problem
  and no runner donates; the roll-back cache survives, the values equal the
  undonated run's.
* Against JAX: the HPO program of ``tests/fixtures.py`` under SAMA with
  an Adam inner problem, donated on both sides, within 1e-6.
* A checkpoint resume under donation equals the uninterrupted run bit for
  bit, in both modes.
* ``zero``, ``fsdp`` (driver and compiled) and ``tp`` at two gloo ranks
  (``tests/torch_donate_impl.py``): donated against undonated bit for bit,
  each rank's shards in their own storage.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from betty_tpu_torch import Config, Engine, EngineConfig, IterativeProblem, optim
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.examples import imagenet_pruning as prune
from betty_tpu_torch.examples import learning_by_ignoring as lbi
from betty_tpu_torch.examples import learning_to_reweight as mwn
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from betty_tpu_torch.module import from_fn
from betty_tpu_torch.utils import tree_copy_, tree_map, tree_paths, unalias

HERE = os.path.dirname(os.path.abspath(__file__))
IMPL = os.path.join(HERE, "torch_donate_impl.py")
STATE_KEYS = ("params", "opt_state", "grad_acc", "last_grad", "extra")


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
        pa, pb = dict(tree_paths(a[name])), dict(tree_paths(b[name]))
        assert set(pa) == set(pb), name
        for k, x in pa.items():
            if torch.is_tensor(x):
                assert x.dtype == pb[k].dtype and torch.equal(x, pb[k]), (name, k)
            else:
                assert x == pb[k], (name, k, x, pb[k])


def _storages(engine):
    return {(name, path): x.data_ptr() for name, s in engine.states.items()
            for path, x in tree_paths({k: s[k] for k in STATE_KEYS if k in s})
            if torch.is_tensor(x)}


def _run_watched(engine):
    """``engine.run()``, reading the state's storages after every step and
    block (the engine's per-step hook); returns the leaves that moved."""
    before, moved = _storages(engine), set()
    check = engine.maybe_validate_checkpoint

    def hook(window=1):
        now = _storages(engine)
        moved.update(k for k in before if now.get(k) != before[k])
        return check(window)

    engine.maybe_validate_checkpoint = hook
    engine.run()
    return moved, len(before)


def _to_float64(engine):
    engine.states = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                             else t, engine.states)
    def f64(x):
        if torch.is_tensor(x) and x.is_floating_point():
            return x.double()
        return x.astype(np.float64) if isinstance(x, np.ndarray) and x.dtype.kind == "f" else x

    for p in engine.problems:
        for loader in p.train_data_loader:
            if isinstance(loader, list):  # batches made up front (learning by ignoring)
                loader[:] = [tuple(map(f64, batch)) for batch in loader]
            else:
                loader.arrays = tuple(map(f64, loader.arrays))


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

OPTS = {
    "sgd": dict(lr=0.1),
    "sgd_momentum_wd": dict(lr=0.1, momentum=0.9, weight_decay=0.01),
    "sgd_nesterov": dict(lr=0.1, momentum=0.9, nesterov=True),
    "adam": dict(lr=0.01),
    "adam_l2": dict(lr=0.01, weight_decay=0.05),
    "adamw": dict(lr=0.01, weight_decay=0.05),
    "adam_schedule": dict(lr=0.05, schedule=lambda step: 0.05 * 0.5 ** (step // 4)),
    "grouped": dict(lr=0.01),
}


def _optimizer(name, params):
    kw = dict(OPTS[name])
    if name == "grouped":
        base = optim.adam(**kw)
        return optim.grouped(base, [{"select": "w", "lr": 0.02, "weight_decay": 0.1},
                                    {"select": None}], params)
    return getattr(optim, name.split("_")[0])(**kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(OPTS))
def test_update_in_place_equals_update(name, dtype):
    rng = np.random.RandomState(0)
    p0 = {"w": torch.tensor(rng.randn(5, 3), dtype=dtype),
          "b": torch.tensor(rng.randn(3), dtype=dtype)}
    opt = _optimizer(name, p0)
    ref, ref_state = dict(p0), opt.init(p0)
    got = {k: v.clone() for k, v in p0.items()}
    state = opt.init(got)
    ptrs = [x.data_ptr() for x in (*got.values(), *(t for _, t in tree_paths(state)
                                                    if torch.is_tensor(t)))]
    for t in range(10):
        noise = {k: torch.tensor(rng.randn(*v.shape), dtype=dtype) for k, v in p0.items()}
        grads = {k: 0.3 * ref[k] + noise[k] for k in ref}
        updates, ref_state = opt.update(grads, ref_state, ref, sched_step=t)
        ref = {k: ref[k] + updates[k] for k in ref}
        state = opt.update_({k: 0.3 * got[k] + noise[k] for k in got}, state, got, sched_step=t)
    for k in ref:
        assert torch.equal(ref[k], got[k]), k
    for (pa, a), (pb, b) in zip(tree_paths(ref_state), tree_paths(state)):
        assert pa == pb and (torch.equal(a, b) if torch.is_tensor(a) else a == b), pa
    assert ptrs == [x.data_ptr() for x in (*got.values(), *(t for _, t in tree_paths(state)
                                                            if torch.is_tensor(t)))]


def test_tree_copy_and_unalias():
    a = {"x": torch.zeros(4), "y": torch.ones(2, 2)}
    ptr = a["x"].data_ptr()
    src = {"x": torch.arange(4.0), "y": a["y"]}
    out = tree_copy_(a, src)
    assert out is a and a["x"].data_ptr() == ptr and torch.equal(a["x"], torch.arange(4.0))
    # a source that overlaps its destination is read before it is written
    base = torch.arange(6.0)
    tree_copy_({"v": base[1:]}, {"v": base[:5]})
    assert torch.equal(base, torch.tensor([0.0, 0, 1, 2, 3, 4]))
    with pytest.raises(ValueError):
        tree_copy_({"x": torch.zeros(3)}, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        tree_copy_({"x": torch.zeros(3)}, {"x": torch.zeros(3, dtype=torch.float64)})
    t = torch.zeros(3)
    tree = unalias({"a": t, "b": t, "c": t[1:], "d": torch.zeros(2), "n": 3})
    assert tree["a"] is t and tree["n"] == 3
    assert len({tree[k].untyped_storage().data_ptr() for k in "abcd"}) == 4


# ---------------------------------------------------------------------------
# donated against undonated, driver mode and compiled
# ---------------------------------------------------------------------------

BERT = ["--dim", "32", "--depth", "1", "--heads", "2", "--seq_len", "16", "--batch_size", "4",
        "--train_size", "48", "--meta_size", "16", "--dropout", "0.1", "--unroll_steps", "2",
        "--device_data", "--device", "cpu"]
PROGRAMS = {  # name: (example, argv, solver config)
    "north_star": (tex, BERT + ["--hypergradient", "sama", "--flash", "--train_iters", "12"],
                   dict(gradient_accumulation=2)),
    "mwn": (mwn, ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
                  "--train_size", "64", "--meta_size", "32", "--train_iters", "4",
                  "--lr_milestones", "2", "--device_data"], {}),
    "cg": (tex, BERT + ["--hypergradient", "cg", "--train_iters", "6"], dict(cg_iterations=2)),
    "neumann": (tex, BERT + ["--hypergradient", "neumann", "--train_iters", "6"],
                dict(neumann_iterations=2)),
    "pruning": (prune, ["--device", "cpu", "--batch_size", "4", "--image_size", "32",
                        "--num_classes", "10", "--width", "8", "--stages", "1", "1", "--gas", "2",
                        "--train_size", "32", "--meta_size", "16", "--train_iters", "8"], {}),
    "lbi": (lbi, ["--device", "cpu", "--train_iters", "8", "--features_lr", "0.08",
                  "--classifier_lr", "0.02"], {}),
    "hooks": (None, [], {}),
}


class _HookedInner(lr.Inner):
    """SAMA's child with clipping, a ``grad_callback`` and the example's
    ``on_inner_loop_start`` (``set_params`` outside an update)."""

    def grad_callback(self):
        self.set_grads_value({k: 0.5 * g for k, g in self.grads.items()})


class _HookedOuter(lr.Outer):
    """A ``custom_optimizer_step`` and a ``param_callback`` that edits the
    other problem's parameters."""

    def custom_optimizer_step(self, params, grads, state):
        return {k: p - 0.5 * grads[k] for k, p in params.items()}

    def param_callback(self):
        self.inner.set_params({k: 0.99 * v for k, v in self.inner.params.items()})


def _hooks_program(compiled):
    train, valid = lr.make_data(seed=0, n=160)
    outer = _HookedOuter(name="outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                         optimizer=optim.sgd(lr=1.0, momentum=0.9),
                         train_data_loader=ArrayLoader(*valid, batch_size=16, seed=1))
    inner = _HookedInner(name="inner", module=from_fn(lambda p, x: (x @ p["w"], p["w"]),
                                                      {"w": torch.zeros(20)}),
                         optimizer=optim.adam(lr=0.1),
                         train_data_loader=ArrayLoader(*train, batch_size=16, seed=0),
                         config=Config(unroll_steps=2, type="sama", gradient_clipping=0.5))
    return Engine(config=EngineConfig(train_iters=10, compile_blocks=compiled),
                  problems=[outer, inner],
                  dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                  device="cpu")


def _program(name, dtype, compiled, donate):
    ex, argv, solver = PROGRAMS[name]
    argv = list(argv) + (["--compile_blocks"] if compiled else [])
    if ex is None:
        engine = _hooks_program(compiled)
    elif ex is tex:
        # bf16 steps (the north star's) in float32, fp32 steps in float64
        argv += ["--precision", "bf16" if dtype == "float32" and name == "north_star" else "fp32"]
        engine = ex.build_engine(ex.parse_args(argv), **solver)
        if name == "north_star":
            engine.classifier.optimizer.schedule = optim.step_lr(2e-5, step_size=3, gamma=0.5)
    else:
        engine = ex.build_engine(ex.parse_args(argv))
    if dtype == "float64":
        _to_float64(engine)
    engine.config.donate_state = donate
    engine.config.block_periods = 1
    return engine


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_donated_equals_undonated_in_both_modes(name, dtype):
    runs = {}
    for compiled in (False, True):
        for donate in (False, True):
            engine = _program(name, dtype, compiled, donate)
            moved, leaves = _run_watched(engine)
            assert all(p.donate == donate for p in engine.problems)
            if compiled:
                assert engine.block_runner.donate == donate
                assert engine.block_runner.periods_run > 0
            if donate:
                assert not moved, sorted(moved)[:4]
            else:
                assert moved  # the out-of-place step makes new tensors
            runs[compiled, donate] = engine
    for engine in runs.values():
        _equal_states(runs[False, False].states, engine.states)
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_paths(runs[False, False].states),
        tree_paths(_program(name, dtype, False, False).states)) if torch.is_tensor(x))


def test_donate_flag_reaches_the_engine_config():
    argv = BERT + ["--train_iters", "2"]
    assert tex.parse_args(argv).donate is False
    assert tex.build_engine(tex.parse_args(argv)).config.donate_state is False
    assert tex.build_engine(tex.parse_args(argv + ["--donate"])).config.donate_state is True


# ---------------------------------------------------------------------------
# JAX's exclusion rule: roll-back caches and ITD children hold old states
# ---------------------------------------------------------------------------


def _hpo(kind, compiled, donate):
    """The logistic-regression HPO program (loaders of 16) with the inner
    problem under roll-back (unroll 4, 10 iterations: the run ends mid-unroll
    with a live cache) or as an ITD child (unroll 2)."""
    train, valid = lr.make_data(seed=0, n=160)
    inner_cls, outer_cfg, unroll = lr.Inner, Config(), 4
    if kind == "itd":
        class ITDInner(IterativeProblem):
            training_step = lr.Inner.training_step
            on_inner_loop_start = lr.Inner.on_inner_loop_start

        inner_cls, outer_cfg, unroll = ITDInner, Config(first_order=False), 2
    outer = lr.Outer(name="outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9),
                     train_data_loader=ArrayLoader(*valid, batch_size=16, seed=1),
                     config=outer_cfg)
    inner = inner_cls(name="inner",
                      module=from_fn(lambda p, x: (x @ p["w"], p["w"]), {"w": torch.zeros(20)}),
                      optimizer=optim.sgd(lr=0.1), train_data_loader=ArrayLoader(
                          *train, batch_size=16, seed=0),
                      config=Config(unroll_steps=unroll))
    engine = Engine(config=EngineConfig(train_iters=10, roll_back=kind == "rollback",
                                        compile_blocks=compiled, donate_state=donate),
                    problems=[outer, inner],
                    dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                    device="cpu")
    return engine, inner


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
@pytest.mark.parametrize("kind", ["rollback", "itd"])
def test_exclusion_rule_turns_donation_off(kind, compiled):
    plain, plain_inner = _hpo(kind, compiled, False)
    plain.run()
    engine, inner = _hpo(kind, compiled, True)
    engine.run()
    assert engine.config.donate_state
    assert not any(p.donate for p in engine.problems)
    if compiled:
        assert not engine.block_runner.donate and engine.block_runner.periods_run > 0
    _equal_states(plain.states, engine.states)
    if kind == "rollback":
        # the cache of the unroll the run ends in survives the steps after it
        assert inner._state_cache is not None
        _equal_states({"inner": plain_inner._state_cache}, {"inner": inner._state_cache})
        assert not torch.equal(inner._state_cache["params"]["w"],
                               engine.states["inner"]["params"]["w"])


# ---------------------------------------------------------------------------
# against the JAX package, and a resume
# ---------------------------------------------------------------------------


def test_donated_matches_jax_donated():
    """The logistic-regression HPO program of ``tests/fixtures.py`` with
    SAMA over an Adam inner problem (``last_grad``), donated on both sides:
    the JAX package's driver mode against the port's driver mode and
    compiled blocks, within the HPO tests' 1e-6 (float32; the slice test
    allows 1e-4)."""
    import betty_tpu
    from fixtures import make_engine

    jeng, _, _ = make_engine(betty_tpu.Config(unroll_steps=4, type="sama"),
                             betty_tpu.EngineConfig(train_iters=40, donate_state=True),
                             inner_optimizer=betty_tpu.optim.adam(lr=0.05))
    jeng.run()
    for compiled in (False, True):
        train, valid = lr.make_data(seed=0)
        outer = lr.Outer(name="outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                         optimizer=optim.sgd(lr=1.0, momentum=0.9), train_data_loader=[valid])
        inner = lr.Inner(name="inner", module=from_fn(lambda p, x: (x @ p["w"], p["w"]),
                                                      {"w": torch.zeros(20)}),
                         optimizer=optim.adam(lr=0.05), train_data_loader=[train],
                         config=Config(unroll_steps=4, type="sama"))
        engine = Engine(config=EngineConfig(train_iters=40, donate_state=True,
                                            compile_blocks=compiled),
                        problems=[outer, inner],
                        dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
                        device="cpu")
        moved, _ = _run_watched(engine)
        assert inner.donate and outer.donate and not moved
        for name in ("inner", "outer"):
            err = np.max(np.abs(engine.states[name]["params"]["w"].numpy()
                                - np.asarray(jeng.states[name]["params"]["w"])))
            assert err <= 1e-6, (compiled, name, err)


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
def test_donated_resume_equals_uninterrupted(tmp_path, compiled):
    """SAMA with dropout and a learning rate that halves after the cut: 6
    donated iterations, a checkpoint, a fresh donated engine resumed by
    ``auto_resume`` to 12; equal to 12 uninterrupted iterations, donated and
    not."""
    def build(iters, donate=True, path=None, auto=False):
        engine = tex.build_engine(tex.parse_args(
            BERT + ["--hypergradient", "sama", "--flash", "--precision", "fp32",
                    "--train_iters", str(iters)] + (["--compile_blocks"] if compiled else [])
            + (["--donate"] if donate else [])))
        engine.classifier.optimizer.schedule = optim.step_lr(2e-5, step_size=5, gamma=0.5)
        if path is not None:
            engine.config.checkpoint_dir, engine.config.checkpoint_step = str(path), 6
            engine.config.auto_resume = auto
        return engine

    plain = build(12, donate=False)
    plain.run()
    full = build(12)
    full.run()
    _equal_states(plain.states, full.states)
    build(6, path=tmp_path).run()
    assert json.loads((tmp_path / "meta.json").read_text())["global_step"] == 6
    resumed = build(12, path=tmp_path, auto=True)
    resumed.maybe_auto_resume()  # the restored tensors are the ones the run updates
    assert resumed.global_step == 6
    moved, _ = _run_watched(resumed)
    assert resumed.classifier.count == 12 and resumed.classifier.donate and not moved
    _equal_states(full.states, resumed.states)


# ---------------------------------------------------------------------------
# zero, fsdp and tp at two gloo ranks
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("donate") / "ranks.json"
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    for k in ("BETTY_COORDINATOR_ADDRESS", "BETTY_NUM_PROCESSES", "BETTY_PROCESS_ID",
              "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, IMPL, str(out)], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", ["zero", "fsdp", "fsdp_compiled", "tp"])
def test_two_gloo_ranks_donated_equal_undonated(gloo, case):
    assert gloo[case]["ok"], gloo[case]
