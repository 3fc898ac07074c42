"""Activation rematerialization in the port on the CPU: ``Config(remat=True)``
(``Problem.build_update_fn``) and ``TransformerClassifier(remat=True,
remat_policy=...)`` (``models/transformer.py``).

* ``Config(remat=True)`` equals ``remat=False`` bit for bit, as
  ``tests/test_quality.py::test_remat_matches_plain`` holds for JAX: on the
  logistic-regression HPO program (and within 1e-6 of JAX's remat run), an
  ITD parent replaying its child with ``create_graph=True`` inside the
  recompute, and the MWN program whose BatchNorm child reports its
  statistics from the recomputed loss, in driver mode and compiled.
* ``TransformerClassifier(remat=True)`` for each policy, with and without
  flash: against JAX's remat model at dropout 0 (float32: logits within
  1e-5, gradients within 1e-4 of the largest, as
  ``tests/test_torch_transformer.py`` holds the plain model), and equal to
  the port's model without remat at dropout 0.1 bit for bit, called
  directly and through ``from_torch`` (whose ``functional_call`` has put
  the module's parameters back before the backward recomputes).
* The selective policy (``None`` with flash) does not run the flash
  forward again in the backward, "minimal" runs it once more per block
  (the count of the forward wrapper's calls; JAX's
  ``test_selective_remat_policy_saves_flash_residuals`` holds residuals).
* A SAMA run with ``--remat`` equals the run without, compiled and in
  driver mode; an invalid ``remat_policy`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betty_tpu
from betty_tpu.models.transformer import TransformerClassifier as JTC
from betty_tpu_torch import Config, Engine, EngineConfig, convert, optim
from betty_tpu_torch.compile import _paths
from betty_tpu_torch.examples import bert_data_reweighting as tex
from betty_tpu_torch.examples import logistic_regression_hpo as lr
from betty_tpu_torch.models import TransformerClassifier
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.ops import flash_attention as fa
from fixtures import make_engine

VOCAB, DIM, DEPTH, HEADS, S, B = 100, 64, 2, 4, 16, 4
POLICIES = [None, "minimal", "dots"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_trees(a, b):
    pa, pb = dict(_paths(a)), dict(_paths(b))
    assert set(pa) == set(pb)
    for k, x in pa.items():
        if torch.is_tensor(x):
            assert torch.equal(x, pb[k]), k
        else:
            assert x == pb[k], k


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, VOCAB, size=(B, S)).astype(np.int32)
    ids[1, 10:] = 1  # padding
    ids[3, 5:] = 1
    return ids


# ---------------------------------------------------------------------------
# Config(remat=True)
# ---------------------------------------------------------------------------


def _hpo(remat):
    """The port's logistic-regression HPO program (``fixtures.make_engine``'s
    counterpart) with ``Config(remat=remat)`` on both problems."""
    train, valid = lr.make_data(seed=0)
    outer = lr.Outer(name="outer", module=from_fn(lambda p: p["w"], {"w": torch.ones(20)}),
                     optimizer=optim.sgd(lr=1.0, momentum=0.9), train_data_loader=[valid],
                     config=Config(remat=remat))
    inner = lr.Inner(name="inner",
                     module=from_fn(lambda p, x: (x @ p["w"], p["w"]), {"w": torch.zeros(20)}),
                     optimizer=optim.sgd(lr=0.1), train_data_loader=[train],
                     config=Config(unroll_steps=5, remat=remat))
    return Engine(config=EngineConfig(train_iters=30), problems=[outer, inner],
                  dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}}, device="cpu")


def test_config_remat_matches_plain_and_jax():
    runs = []
    for remat in (False, True):
        engine = _hpo(remat)
        assert all(p.config.remat == remat for p in engine.problems)
        engine.run()
        runs.append(engine.states)
    _equal_trees(runs[0], runs[1])
    jeng, outer, _ = make_engine(betty_tpu.Config(unroll_steps=5, remat=True),
                                 betty_tpu.EngineConfig(train_iters=30))
    outer._config = dataclasses.replace(outer.config, remat=True)
    jeng.run()
    for name in ("inner", "outer"):
        err = np.max(np.abs(runs[1][name]["params"]["w"].numpy()
                            - np.asarray(jeng.states[name]["params"]["w"])))
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
def test_config_remat_itd_parent_and_batchnorm_child(compiled):
    """The MWN program through ITD (unroll 3): the reweighter's direct loss,
    recomputed in the backward, replays the classifier's unroll with
    ``create_graph=True``; the classifier's BatchNorm reports its statistics
    from a loss that is recomputed too. Equal to the run without remat."""
    import chip_smoke

    argv = ["--device", "cpu", "--stage_sizes", "1,1,1", "--batch_size", "8",
            "--train_size", "64", "--meta_size", "32", "--train_iters", "6",
            "--unroll_steps", "3", "--lr_milestones", "2", "--device_data"]
    runs = []
    for remat in (False, True):
        engine = chip_smoke.mwn_variant(argv + (["--compile_blocks"] if compiled else []),
                                        "itd")
        for p in engine.problems:
            p._config = dataclasses.replace(p.config, remat=remat)
            p._update_fns = {}
        engine.config.block_periods = 1
        engine.run()
        runs.append(engine)
    assert runs[1].reweight.config.remat and not runs[1].reweight.config.first_order
    if compiled:
        assert runs[1].block_runner.periods_run == 2
    for name in ("classifier", "reweight"):
        _equal_trees(runs[0].states[name], runs[1].states[name])


# ---------------------------------------------------------------------------
# TransformerClassifier(remat=True)
# ---------------------------------------------------------------------------


def _model(use_flash, dropout, remat=False, policy=None):
    return TransformerClassifier(vocab_size=VOCAB, max_len=S, dim=DIM, depth=DEPTH,
                                 heads=HEADS, dropout=dropout, use_flash=use_flash,
                                 remat=remat, remat_policy=policy)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("policy", POLICIES, ids=["full", "minimal", "dots"])
def test_remat_model_matches_jax(policy, use_flash):
    jm = JTC(vocab_size=VOCAB, max_len=S, dim=DIM, depth=DEPTH, heads=HEADS, dropout=0.0,
             use_flash=use_flash, remat=True, remat_policy=policy)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32), train=False)["params"]
    ids = _ids()
    w = np.random.RandomState(1).randn(B, 2).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(ids), train=True)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tm = _model(use_flash, 0.0, True, policy)
    tp = convert.from_flax_transformer(jax.tree_util.tree_map(np.asarray, jp))
    assert set(tp) == {n for n, _ in tm.named_parameters()}
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tout = torch.func.functional_call(tm, tp, (torch.tensor(ids),), {"train": True})
    names = list(tp)
    tgrad = torch.autograd.grad((tout * torch.tensor(w)).sum(), [tp[n] for n in names])
    assert np.max(np.abs(tout.detach().numpy() - np.asarray(jout))) < 1e-5
    jg = convert.from_flax_transformer(jax.tree_util.tree_map(np.asarray, jgrad))
    scale = max(float(np.max(np.abs(g.numpy()))) for g in jg.values())
    for n, g in zip(names, tgrad):
        err = np.max(np.abs(g.numpy() - jg[n].numpy()))
        assert err <= 1e-4 * scale, (n, err, scale)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("policy", POLICIES, ids=["full", "minimal", "dots"])
def test_remat_model_equals_plain_model_with_dropout(policy, use_flash):
    """Dropout 0.1: each block draws its masks from its own generator, made
    from its seed inside the recomputed segment, so the recompute draws the
    forward's masks; logits and gradients equal the model without remat's,
    through ``from_torch`` (the engine's path) as well as called directly."""
    ids = torch.tensor(_ids())
    plain, remat = _model(use_flash, 0.1), _model(use_flash, 0.1, True, policy)
    remat.load_state_dict(plain.state_dict())
    outs = []
    for m in (plain, remat):
        out = m(ids, train=True, rngs={"dropout": 7})
        grads = torch.autograd.grad(out.square().sum(), list(m.parameters()))
        fm = from_torch(m)
        params = {k: v.clone().requires_grad_(True) for k, v in fm.init(None)["params"].items()}
        fout = fm.apply({"params": params}, ids, train=True, rngs={"dropout": 7})
        fgrads = torch.autograd.grad(fout.square().sum(), list(params.values()))
        outs.append((out, grads, fout, fgrads))
    (o0, g0, f0, fg0), (o1, g1, f1, fg1) = outs
    assert torch.equal(o0, o1) and torch.equal(f0, f1) and torch.equal(o0, f0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(fg0, fg1))
    assert all(torch.equal(a, b) for a, b in zip(g0, fg0))
    # dropout is on: another seed draws other masks
    assert not torch.equal(o1, remat(ids, train=True, rngs={"dropout": 8}))


@pytest.mark.parametrize("policy,replayed", [(None, 0), ("minimal", DEPTH), ("dots", 0)],
                         ids=["full", "minimal", "dots"])
def test_flash_forward_replayed_only_under_minimal(monkeypatch, policy, replayed):
    """With flash, the selective policies keep the kernel's residuals: one
    forward call a block and no call in the backward; "minimal" calls the
    forward once more for each block the backward recomputes. The backward
    kernel runs once a block under every policy."""
    calls = {"_fwd_single": 0, "_bwd_single": 0}
    for name in calls:
        wrapper = getattr(fa, name)

        def counted(*args, _w=wrapper, _n=name, **kwargs):
            calls[_n] += 1
            return _w(*args, **kwargs)

        monkeypatch.setattr(fa, name, counted)
    m = _model(True, 0.1, True, policy)
    out = m(torch.tensor(_ids()), train=True, rngs={"dropout": 3})
    assert calls == {"_fwd_single": DEPTH, "_bwd_single": 0}
    torch.autograd.grad(out.sum(), list(m.parameters()))
    assert calls == {"_fwd_single": DEPTH + replayed, "_bwd_single": DEPTH}


def test_invalid_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy='everything'"):
        _model(True, 0.1, True, "everything")
    # as in JAX, the policy is read only with remat on
    assert not _model(True, 0.1, False, "everything").remat


@pytest.mark.parametrize("compiled", [False, True], ids=["driver", "compiled"])
@pytest.mark.parametrize("policy", ["full", "minimal", "dots"])
def test_sama_run_with_remat_equals_without(policy, compiled):
    """The small SAMA run (dropout 0.1, Adam, flash) with ``--remat`` equals
    the run without, in driver mode and compiled."""
    argv = ["--dim", "32", "--depth", "2", "--heads", "2", "--seq_len", "16",
            "--batch_size", "4", "--train_size", "32", "--meta_size", "16",
            "--precision", "fp32", "--dropout", "0.1", "--unroll_steps", "2",
            "--train_iters", "6", "--hypergradient", "sama", "--flash", "--device_data",
            "--device", "cpu"] + (["--compile_blocks"] if compiled else [])
    runs = []
    for flags in ([], ["--remat", "--remat_policy", policy]):
        engine = tex.build_engine(tex.parse_args(argv + flags))
        engine.run()
        runs.append(engine)
    for name in ("classifier", "reweight"):
        _equal_trees(runs[0].states[name], runs[1].states[name])
