"""darts, SAMA, CG and Neumann hypergradients of the port against
betty_tpu and torch autograd in float64 (within 1e-10). Runs
torch_solvers_impl.py in a subprocess so float64 JAX does not leak into the
float32 test process."""

import os
import subprocess
import sys


def test_torch_solvers_match_betty_tpu_in_float64():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    result = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "torch_solvers_impl.py")],
        capture_output=True, text=True, env=env, timeout=600)
    print(result.stdout)
    print(result.stderr, file=sys.stderr)
    assert result.returncode == 0, "port hypergradients diverge from betty_tpu"
    assert result.stdout.count("OK ") == 22
