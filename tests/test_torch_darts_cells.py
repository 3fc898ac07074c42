"""The port's DARTS MixedOp and cells against flax's
(``betty_tpu/models/darts.py``) on the same numpy-seeded inputs, with the
port's weights carried to flax (``torch_darts_common.compare``), in float32
(1e-5) and float64 (1e-10): output, new running statistics, and the
gradients to the params, the inputs and the architecture weights ("none"
included) of MixedOp at stride 1 and 2 and of a normal cell, a reduction
cell and a normal cell after a reduction (whose s0 is twice s1's size).
"""

import numpy as np
import pytest
import torch

from betty_tpu.models import darts as J
from betty_tpu_torch.models import darts as T
from torch_darts_common import assert_within, compare, one_thread

DTYPES = [torch.float32, torch.float64]
IDS = ["f32", "f64"]

one_thread = pytest.fixture(autouse=True)(one_thread)


def _images(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_op_matches_flax(stride, dtype):
    """The weighted sum of the 8 primitives; the gradient to the weights
    includes "none"'s (zero) entry."""
    weights = np.random.RandomState(3).rand(len(T.PRIMITIVES))
    errs = compare(J.MixedOp(4, stride), T.MixedOp(4, stride), [_images((2, 8, 8, 4))], dtype,
                    extra=[weights])
    assert_within(errs, dtype)


CELLS = {  # (reduction, reduction_prev): s0 is twice s1's size after a reduction
    "normal": (False, False),
    "reduction": (True, False),
    "after_reduction": (False, True),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_matches_flax(kind, dtype):
    reduction, reduction_prev = CELLS[kind]
    c, c_pp, c_p = 2, 6, 8
    hw0 = 16 if reduction_prev else 8
    weights = np.random.RandomState(4).rand(T.NUM_EDGES, len(T.PRIMITIVES))
    errs = compare(J.Cell(c, reduction, reduction_prev),
                    T.Cell(c_pp, c_p, c, reduction, reduction_prev),
                    [_images((2, hw0, hw0, c_pp), 1), _images((2, 8, 8, c_p), 2)], dtype,
                    extra=[weights])
    assert_within(errs, dtype)
