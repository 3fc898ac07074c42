"""Robust NAS: the port's ``examples/robust_nas.py`` against the JAX
package's ``examples/robust_nas/main.py``.

* ``jacobian_reg`` (JAX's direction injected), ``cure_reg`` and
  ``curvature_reg`` (JAX's start injected) on the same loss and input:
  values and parameter gradients within 1e-10 in float64
  (``torch_robust_impl.py regularizers``, in a subprocess).
* The robust program on the ``mlp`` backbone, 4 meta-periods with both
  regularizers, JAX's Jacobian directions injected: alphas and parameters
  within 1e-8 in float64 (``torch_robust_impl.py mlp``). The supernet's
  regularized loss is in ``test_torch_robust_nas_darts*.py``.
* The power-iteration monitor finds the top eigenvalue of the input
  Hessian and its gradient through H (``tests/test_examples2.py::
  test_robust_nas_power_iteration_curvature``), within 2 %.
* Compiled blocks equal driver mode bit for bit on both backbones, with
  the Jacobian directions' generator reseeded every period.
* Zero coefficients skip their terms; the CLI's defaults are the JAX
  example's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from betty_tpu_torch import compile as tcompile
from betty_tpu_torch import utils
from betty_tpu_torch.examples import robust_nas as trob
from torch_darts_common import equal_trees, jax_cli_defaults, one_thread, run_robust_impl

ROOT = Path(__file__).resolve().parents[1]
CASES = ("regularizers", "mlp")

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def robust_runs():
    return run_robust_impl(CASES)


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_in_float64(robust_runs, case):
    lines = robust_runs[case]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)


def test_power_iteration_finds_the_top_eigenvalue_and_its_gradient():
    rng = np.random.RandomState(0)
    M = rng.randn(12, 12).astype(np.float32)
    A = torch.tensor(M @ M.T)  # PSD: the top eigenvalue dominates strictly
    lam_true = float(np.max(np.linalg.eigvalsh(M @ M.T)))
    x = torch.tensor(rng.randn(12).astype(np.float32))

    lam = float(trob.curvature_reg(lambda z: 0.5 * z @ A @ z, x, 0, iters=50))
    assert abs(lam - lam_true) / lam_true < 0.02, (lam, lam_true)

    # d/dtheta lambda_max(theta * A) = lambda_max(A): the gradient flows
    # through H
    theta = torch.tensor(1.0, requires_grad=True)
    lam_of = trob.curvature_reg(lambda z: 0.5 * theta * (z @ A @ z), x, 0, iters=30)
    (g,) = torch.autograd.grad(lam_of, theta)
    assert abs(float(g) - lam_true) / lam_true < 0.02, (float(g), lam_true)


SMALL = ["--device", "cpu", "--batch_size", "4", "--train_size", "16", "--valid_step", "1000"]
BACKBONES = {"mlp": ["--arch", "mlp"], "darts": ["--channels", "2", "--layers", "1"]}


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_compiled_equals_driver_bit_for_bit(monkeypatch, backbone):
    argv = SMALL + BACKBONES[backbone] + ["--train_iters", "5"]
    driver = trob.build_engine(trob.parse_args(argv))
    record = tcompile._StepValues()
    with utils.step_values(record):
        driver.run()

    written = []
    orig = tcompile._Slots.write

    def spy(self, r):
        out = orig(self, r)
        written.append(out)
        return out

    monkeypatch.setattr(tcompile._Slots, "write", spy)
    compiled = trob.build_engine(trob.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    runner = compiled.block_runner
    assert runner is not None and runner.periods_run >= 3 and len(written) == runner.periods_run
    assert driver.classifier.count == compiled.classifier.count == 5
    equal_trees(driver.states, compiled.states)
    # the Jacobian directions: a generator of the reseeded pool (the
    # classifier's step and darts' two evaluations), reseeded with driver
    # mode's seeds and fresh every period
    seeds = [s for _, _, ss in written for s in ss]
    assert len(written[0][2]) == 3
    assert seeds == [int(s) for s in record.seeds][-len(seeds):]
    assert all(a != b for r in range(len(written) - 1)
               for a, b in zip(written[r][2], written[r + 1][2]))


def test_zero_coefficients_skip_their_terms(monkeypatch):
    engine = trob.build_engine(trob.parse_args(SMALL + ["--arch", "mlp", "--lambda_j", "0",
                                                        "--lambda_c", "0"]))
    ctx = {n: {"params": s["params"], "extra": s["extra"]} for n, s in engine.states.items()}
    batch = engine.classifier.get_batch()
    calls = []
    input_grad = trob.input_grad
    monkeypatch.setattr(trob, "input_grad", lambda *a: calls.append(a) or input_grad(*a))
    loss, loss_dict, _ = engine.classifier.eval_loss(ctx, batch, rng=0)
    assert calls == [] and torch.equal(loss, loss_dict["ce"])
    # one input gradient at x serves the loss and both terms; CURE adds the
    # one at x + z
    for lambda_j, lambda_c, n in ((0.1, 0.0, 1), (0.0, 0.01, 2), (0.1, 0.01, 2)):
        calls.clear()
        engine.classifier.cfg = {"lambda_j": lambda_j, "lambda_c": lambda_c}
        engine.classifier.eval_loss(ctx, batch, rng=0)
        assert len(calls) == n, (lambda_j, lambda_c, len(calls))


def test_cli_defaults_are_the_jax_example():
    """DARTS's search widths, SGD without a schedule, no roll-back; the port
    adds ``--device`` (cuda), compiled blocks and checkpoints."""
    ours = vars(trob.parse_args([]))
    theirs = jax_cli_defaults(ROOT / "examples" / "robust_nas" / "main.py")
    theirs.pop("data_dir")
    assert ours["device"] == "cuda"
    assert {k: ours[k] for k in theirs} == theirs
    assert set(ours) - set(theirs) == {"device", "compile_blocks", "checkpoint_dir",
                                       "checkpoint_step"}
    engine = trob.build_engine(trob.parse_args(["--device", "cpu", "--arch", "mlp"]))
    assert not engine.config.roll_back and engine.classifier.optimizer.schedule is None


def test_validation_logs_the_genotype(monkeypatch):
    engine = trob.build_engine(trob.parse_args(SMALL + ["--arch", "mlp", "--train_iters", "2",
                                                        "--valid_step", "1"]))
    messages = []
    monkeypatch.setattr(engine.logger, "info", messages.append)
    engine.run()
    assert sum(m.startswith("genotype = Genotype(") for m in messages) == 2


@pytest.mark.parametrize("kernel,stride,dilation,pads", [(3, 1, 1, (1, 1)), (5, 2, 1, (0, 0)),
                                                         (3, 2, 2, (1, 1)), (5, 1, 2, (4, 4))])
def test_grouped_conv_matches_conv2d_to_second_order(kernel, stride, dilation, pads):
    """``models/layers.py::grouped_conv2d`` (ROADMAP §C.8): the values, the
    first derivatives and the derivatives of a function of the input
    gradient (the robust loss's second-order pass) equal ``F.conv2d``'s in
    float64, forward mode too, and a first-order backward bit for bit; its
    double backward makes no per-group convolution."""
    import chip_smoke
    import torch.nn.functional as F
    from betty_tpu_torch.models.layers import grouped_conv2d

    gen = torch.Generator().manual_seed(kernel * 10 + stride + dilation)
    C = 6
    x = torch.randn(2, C, 11, 11, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(C, 1, kernel, kernel, dtype=torch.float64, generator=gen, requires_grad=True)
    u = torch.randn(2, C, 11, 11, dtype=torch.float64, generator=gen)
    results = []
    for conv in (lambda a, b: F.conv2d(a, b, None, stride, pads, dilation, C),
                 lambda a, b: grouped_conv2d(a, b, stride, pads, dilation, C)):
        with chip_smoke._ConvCount() as count:
            y = conv(x, w)
            gx, gw = torch.autograd.grad(torch.sin(y).sum(), (x, w), create_graph=True)
            hx, hw = torch.autograd.grad((gx * u).sum() + (gx ** 2).sum(), (x, w))
        _, tangent = torch.func.jvp(conv, (x.detach(), w.detach()), (u, torch.ones_like(w)))
        results.append(((y, gx, gw, hx, hw, tangent), count.per_group))
    (want, per_group), (got, ours) = results
    for a, b in zip(want, got):
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(a.abs().max()))
    assert per_group == C and ours == 0
    # a first-order backward is F.conv2d's own call: bit for bit
    first = [torch.autograd.grad(torch.sin(conv(x, w)).sum(), (x, w)) for conv in (
        lambda a, b: F.conv2d(a, b, None, stride, pads, dilation, C),
        lambda a, b: grouped_conv2d(a, b, stride, pads, dilation, C))]
    assert all(torch.equal(a, b) for a, b in zip(*first))
