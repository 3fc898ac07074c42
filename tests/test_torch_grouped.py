"""Per-parameter-group optimizers (``optim.grouped``, the
``Problem.param_groups`` hook) against ``torch.optim`` and the JAX
package's ``optim.grouped``.

* ``tests/test_optim.py::test_param_groups_vs_torch``'s steps (a StepLR
  base schedule scaled per group, a momentum group, a momentum-0 group
  with weight decay) against ``torch.optim.SGD`` param groups in float64;
* five steps of several specs (that one, a per-group schedule, Adam and
  AdamW groups with their own betas and eps) against JAX's in float32;
* the group rules: first match wins, ``select=None`` catches all, a leaf
  no group matches raises, an optimizer not made by a factory raises, a
  momentum-0 group keeps no trace, ``adam_moments`` merges the groups'
  moments and raises for a non-Adam group;
* the port's counterpart of ``test_optim.py::_run_param_groups_program``:
  the lr-0 group bit-identical after training, compiled blocks equal to
  driver mode bit for bit, with and without a schedule that changes
  inside the run;
* a grouped learning-by-ignoring run resumed from a checkpoint equals the
  uninterrupted one bit for bit, and a grouped checkpoint restored into an
  ungrouped problem raises, naming both structures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from betty_tpu import optim as joptim
from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.examples import learning_by_ignoring as lbi
from betty_tpu_torch.module import from_fn
from torch_darts_common import equal_trees, one_thread

one_thread = pytest.fixture(autouse=True)(one_thread)

STEPS = 5
SHAPE = (7, 3)


def test_sgd_groups_match_torch_param_groups():
    torch.manual_seed(0)
    pa = torch.nn.Parameter(torch.randn(*SHAPE, dtype=torch.float64))
    pb = torch.nn.Parameter(torch.randn(*SHAPE, dtype=torch.float64))
    p = {"feat": {"w": pa.detach().clone()}, "fc": {"w": pb.detach().clone()}}
    opt = torch.optim.SGD([
        {"params": [pa], "lr": 0.1, "momentum": 0.9},
        {"params": [pb], "lr": 0.01, "momentum": 0.0, "weight_decay": 0.1},
    ], lr=0.05)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.5)
    base = optim.sgd(lr=0.05, momentum=0.9, schedule=optim.step_lr(0.05, step_size=2, gamma=0.5))
    grp = optim.grouped(base, [
        {"select": r"^feat", "lr": 0.1, "momentum": 0.9},
        {"select": None, "lr": 0.01, "momentum": 0.0, "weight_decay": 0.1},
    ], p)
    state = grp.init(p)
    assert state["groups"][1] == {}  # no momentum: no trace
    rng = np.random.RandomState(1)
    for step in range(STEPS):
        ga, gb = rng.randn(*SHAPE), rng.randn(*SHAPE)
        opt.zero_grad()
        pa.grad, pb.grad = torch.as_tensor(ga), torch.as_tensor(gb)
        opt.step()
        sched.step()
        g = {"feat": {"w": torch.as_tensor(ga)}, "fc": {"w": torch.as_tensor(gb)}}
        updates, state = grp.update(g, state, p, sched_step=step)
        p = {k: {"w": p[k]["w"] + updates[k]["w"]} for k in p}
    assert torch.max(torch.abs(p["feat"]["w"] - pa.detach())) < 1e-12
    assert torch.max(torch.abs(p["fc"]["w"] - pb.detach())) < 1e-12


def _spec(name, lib):
    m = joptim if lib == "jax" else optim
    if name == "sgd_steplr":
        base = m.sgd(lr=0.05, momentum=0.9, schedule=m.step_lr(0.05, step_size=2, gamma=0.5))
        return base, [{"select": r"^feat", "lr": 0.1, "momentum": 0.9},
                      {"select": None, "lr": 0.01, "momentum": 0.0, "weight_decay": 0.1}]
    if name == "group_schedule":
        base = m.sgd(lr=0.05, momentum=0.5)
        return base, [{"select": r"feat/w", "lr": 0.1, "schedule": m.step_lr(0.1, 1, 0.7)},
                      {"select": r"^feat", "lr": 0.02},
                      {"select": None}]
    if name == "adam":
        base = m.adam(lr=0.01, schedule=m.cosine_lr(0.01, total_steps=4))
        return base, [{"select": r"^fc", "lr": 0.03, "betas": (0.8, 0.99), "eps": 1e-6},
                      {"select": None, "weight_decay": 0.01}]
    base = m.adamw(lr=0.01, weight_decay=0.05)
    return base, [{"select": r"/b$", "weight_decay": 0.0}, {"select": None, "lr": 0.02}]


@pytest.mark.parametrize("name", ["sgd_steplr", "group_schedule", "adam", "adamw"])
def test_groups_match_jax_grouped(name):
    rng = np.random.RandomState(0)
    p0 = {"feat": {"w": rng.randn(5, 3), "b": rng.randn(3)}, "fc": {"w": rng.randn(3, 2)}}
    p0 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), p0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = {k: {n: torch.tensor(a) for n, a in v.items()} for k, v in p0.items()}
    jg, tg = joptim.grouped(*_spec(name, "jax"), jp), optim.grouped(*_spec(name, "torch"), tp)
    js, ts = jg.init(jp), tg.init(tp)
    for step in range(STEPS):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), p0)
        ju, js = jg.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           sched_step=jnp.asarray(step))
        tu, ts = tg.update({k: {n: torch.tensor(a) for n, a in v.items()} for k, v in g.items()},
                           ts, tp, sched_step=step)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tp = {k: {n: tp[k][n] + tu[k][n] for n in tp[k]} for k in tp}
    for k in p0:
        for n in p0[k]:
            assert np.max(np.abs(tp[k][n].numpy() - np.asarray(jp[k][n]))) <= 1e-6, (k, n)
    if tg.kind == "adam":
        jmu, jnu = jg.adam_moments(js)
        tmu, tnu = tg.adam_moments(ts)
        for k in p0:
            for n in p0[k]:
                np.testing.assert_allclose(tmu[k][n].numpy(), np.asarray(jmu[k][n]), rtol=1e-6,
                                           atol=1e-7)
                np.testing.assert_allclose(tnu[k][n].numpy(), np.asarray(jnu[k][n]), rtol=1e-6,
                                           atol=1e-7)


def test_group_rules():
    p = {"layers.0.weight": torch.zeros(2), "layers.1.weight": torch.zeros(2)}
    grp = optim.grouped(optim.sgd(lr=0.1), [{"select": r"layers\.", "lr": 0.5},
                                            {"select": r"layers\.1", "lr": 0.2}], p)
    assert grp.labels == {"layers.0.weight": 0, "layers.1.weight": 0}  # the first match wins
    with pytest.raises(ValueError, match="no group matches parameter 'layers.1.weight'"):
        optim.grouped(optim.sgd(lr=0.1), [{"select": r"layers\.0", "lr": 0.5}], p)
    raw = optim.Optimizer("sgd", 0.1)
    with pytest.raises(ValueError, match="factory"):
        optim.grouped(raw, [{"select": None}], p)
    sgd = optim.grouped(optim.sgd(lr=0.1, momentum=0.9), [{"select": None}], p)
    with pytest.raises(ValueError, match="Adam-family; group 0"):
        sgd.adam_moments(sgd.init(p))
    adam = optim.grouped(optim.adam(lr=0.1), [{"select": r"\.0\."}, {"select": None}], p)
    st = adam.init(p)
    assert [sorted(s["mu"]) for s in st["groups"]] == [["layers.0.weight"], ["layers.1.weight"]]
    mu, nu = adam.adam_moments(st)
    assert list(mu) == list(nu) == list(p)


def _param_groups_program(compile_blocks, schedule=False, iters=3):
    """``tests/test_optim.py::_run_param_groups_program``: a bilevel program
    whose inner problem trains ``feat`` at lr 0.1 and freezes ``fc`` (lr
    0); returns the engine."""

    class Outer(ImplicitProblem):
        def training_step(self, batch):
            x, y = batch
            return F.binary_cross_entropy_with_logits(self.inner(x), y)

    class Inner(ImplicitProblem):
        def training_step(self, batch):
            x, y = batch
            out = x @ self.params["feat"] + self.params["fc"].sum()
            reg = self.outer()[0]
            l2 = sum(torch.sum(p * p) for p in self.params.values())
            return F.binary_cross_entropy_with_logits(out, y) + 0.5 * reg * l2

        def param_groups(self):
            return [{"select": r"^feat", "lr": 0.1},
                    {"select": None, "lr": 0.0}]  # frozen group

    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype(np.float32)
    y = (rng.rand(32) > 0.5).astype(np.float32)
    sched = optim.step_lr(0.05, step_size=2, gamma=0.5) if schedule else None
    inner = Inner("inner",
                  module=from_fn(lambda p, i: i @ p["feat"] + p["fc"].sum(),
                                 {"feat": torch.zeros(4), "fc": torch.ones(2)}),
                  optimizer=optim.sgd(lr=0.05, schedule=sched), train_data_loader=[(x, y)],
                  config=Config(type="darts"))
    outer = Outer("outer", module=from_fn(lambda p: p["w"], {"w": torch.full((1,), 0.01)}),
                  optimizer=optim.sgd(lr=0.01), train_data_loader=[(x, y)], config=Config())
    eng = Engine(config=EngineConfig(train_iters=iters, compile_blocks=compile_blocks),
                 problems=[outer, inner], dependencies={"u2l": {outer: [inner]},
                                                        "l2u": {inner: [outer]}},
                 device="cpu")
    eng.run()
    return eng


def test_param_groups_hook_trains_one_group_and_freezes_the_other():
    eng = _param_groups_program(compile_blocks=False)
    assert isinstance(eng.inner.optimizer, optim.GroupedOptimizer)
    params = eng.states["inner"]["params"]
    assert float(params["feat"].abs().max()) > 0, "the lr 0.1 group did not train"
    assert torch.equal(params["fc"], torch.ones(2)), "the lr 0 group moved"


@pytest.mark.parametrize("schedule", [False, True])
def test_param_groups_compiled_equals_driver(schedule):
    """Each group's learning rate is its own per-step scalar: with a base
    schedule that halves every 2 steps, a compiled block serves every
    group its current rate (the runner checks the counts it read)."""
    driver = _param_groups_program(False, schedule, iters=8)
    compiled = _param_groups_program(True, schedule, iters=8)
    runner = compiled.block_runner
    assert runner is not None and runner.periods_run >= 1
    equal_trees(driver.states, compiled.states)
    assert torch.equal(compiled.states["inner"]["params"]["fc"], torch.ones(2))


LBI = ["--device", "cpu", "--dim", "16", "--classes", "3", "--n_source", "128", "--n_target",
       "128", "--batch", "32", "--features_lr", "0.08", "--classifier_lr", "0.02"]


def _lbi(iters, **config):
    engine = lbi.build_engine(lbi.parse_args(LBI + ["--train_iters", str(iters)]))
    for k, v in config.items():
        setattr(engine.config, k, v)
    return engine


def test_grouped_lbi_resumed_equals_uninterrupted(tmp_path):
    whole = _lbi(8)
    whole.run()
    cut = _lbi(4, checkpoint_dir=str(tmp_path), checkpoint_step=4)
    cut.run()
    resumed = _lbi(8, checkpoint_dir=str(tmp_path), auto_resume=True)
    resumed.run()
    assert resumed.global_step == 8 and [p.count for p in resumed.problems] == [8, 8, 8]
    assert len(resumed.states["finetune"]["opt_state"]["groups"]) == 2
    equal_trees(whole.states, resumed.states)


def test_grouped_checkpoint_into_ungrouped_problem_names_both(tmp_path):
    cut = _lbi(4, checkpoint_dir=str(tmp_path), checkpoint_step=4)
    cut.run()

    class Plain(lbi.Finetune):
        param_groups = None  # not callable: no groups

    saved = lbi.Finetune
    lbi.Finetune = Plain
    try:
        plain = _lbi(4)
    finally:
        lbi.Finetune = saved
    assert not isinstance(plain.finetune.optimizer, optim.GroupedOptimizer)
    with pytest.raises(ValueError) as err:
        plain.load_checkpoint(str(tmp_path))
    msg = str(err.value)
    assert "'finetune'" in msg and "current:" in msg and "checkpoint:" in msg
    assert "'groups'" in msg.split("checkpoint:")[1] and "'groups'" not in \
        msg.split("checkpoint:")[0]
