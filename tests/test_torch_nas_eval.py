"""The DARTS evaluation phase: the port's ``examples/nas_eval.py`` against
the JAX package's ``examples/neural_architecture_search/train.py``.

* DARTS_V2 at C4 L4 B8 with the auxiliary head, cutout and drop-path 0,
  gradients clipped (the clip is active), 3 steps, from the same weights on
  the same batches in float64 (``torch_nas_impl.py eval``, in a
  subprocess, about 45 s): parameters and batch_stats within 1e-8.
* Compiled blocks equal driver mode bit for bit on the CPU with drop-path
  0.2 (its draws from the generator pool and the per-step probability in
  the batch).
* The loader ramps drop-path by epoch and cuts a square out of every image.
"""

import numpy as np
import pytest
import torch

from betty_tpu_torch.examples import nas_eval as teval
from torch_darts_common import equal_trees as _equal
from torch_darts_common import one_thread, run_nas_impl

EVAL = ["--device", "cpu", "--batch_size", "8", "--train_size", "24", "--init_channels", "4",
        "--layers", "3", "--auxiliary", "--cutout", "--valid_every_epochs", "10"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def test_eval_matches_jax_in_float64():
    run_nas_impl("eval")


def test_eval_compiled_equals_driver_bit_for_bit():
    """Drop-path 0.2 ramped over 2 epochs: every replay draws fresh masks
    from the pool's generators, as driver mode does."""
    argv = EVAL + ["--epochs", "2", "--drop_path_prob", "0.2"]
    driver = teval.build_engine(teval.parse_args(argv))
    driver.run()
    compiled = teval.build_engine(teval.parse_args(argv + ["--compile_blocks"]))
    compiled.config.block_periods = 1
    compiled.run()
    assert compiled.block_runner is not None and compiled.block_runner.periods_run >= 4
    assert driver.network.count == compiled.network.count == 6
    _equal(driver.states, compiled.states)
    # drop-path drew: the same run at probability 0 ends elsewhere
    other = teval.build_engine(teval.parse_args(EVAL + ["--epochs", "2", "--drop_path_prob",
                                                        "0.0"]))
    other.run()
    assert any(not torch.equal(a, b) for a, b in zip(driver.states["network"]["params"].values(),
                                                     other.states["network"]["params"].values()))


def test_eval_loader_ramps_drop_path_and_cuts_out():
    args = teval.parse_args(EVAL + ["--epochs", "2", "--drop_path_prob", "0.2"])
    loader = teval.build_engine(args).network.train_data_loader[0]
    x, y, dp = next(iter(loader))
    assert dp == np.float32(0.0) and x.shape == (8, 32, 32, 3)
    assert ((x == 0).all(axis=-1).sum(axis=(1, 2)) > 0).all()  # a square of every image
    loader.set_epoch(1)
    assert next(iter(loader))[2] == np.float32(0.1)
