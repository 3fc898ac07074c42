"""Iterative differentiation of the port (``IterativeProblem``) against
betty_tpu: the cases of tests/test_itd.py in float64, run by
``torch_itd_impl.py`` in a subprocess (float64 JAX must not leak into the
float32 test process). The MAML meta-gradient with and without gradient
accumulation and the roll-back re-step within 1e-10 of betty_tpu (and of
the derivative written out by hand), betty_tpu's warning for
``first_order=False`` above an implicit child, and the replay of an unroll
with momentum, an LR schedule and clipping on the eager trajectory (1e-12)
and on betty_tpu's (1e-10), and the meta step through SGD with nesterov
momentum and weight decay, Adam and AdamW under schedules (1e-10). The
compiled MAML case is in test_torch_compile.py, the MWN case in
torch_mwn_impl.py."""

import os
import subprocess
import sys

import pytest

ITD_CASES = ("maml", "maml_gas", "warns", "rollback_restep", "replay", "optimizers")


def run_impl(cases):
    """``torch_itd_impl.py`` on ``cases`` in a subprocess; its output."""
    # few threads: the test workers share the machine's cores
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    result = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "torch_itd_impl.py"), *cases],
        capture_output=True, text=True, env=env, timeout=600)
    print(result.stdout)
    print(result.stderr[-3000:], file=sys.stderr)
    return result.stdout


@pytest.fixture(scope="module")
def itd_runs():
    return run_impl(ITD_CASES)


@pytest.mark.parametrize("case", ITD_CASES)
def test_itd_matches_betty_tpu_in_float64(itd_runs, case):
    lines = [line for line in itd_runs.splitlines() if f'"case": "{case}"' in line]
    assert len(lines) == 1 and lines[0].startswith("OK "), (case, lines)
