"""The port's DARTS evaluation network against flax's
(``betty_tpu/models/darts.py``) on the same numpy-seeded images, with the
port's weights carried to flax (``torch_darts_common.compare``):
``DARTSEvalNetwork`` on DARTS_V2 at C4 L6 with the auxiliary head (at the
cell 4, on its 8x8 map) and drop-path 0, 32x32 images. Train mode: logits,
auxiliary logits, the new running statistics and the gradients to the
params and the input; eval mode: logits, no auxiliary output. float64
within 1e-10 throughout. float32: outputs and running statistics within
1e-4 (the auxiliary logits come out of a BatchNorm over the batch alone,
8 values a feature, which magnifies float32 rounding to about 1.5e-5), and
no gradients: a ReLU input or a max-pool pair within float32 rounding of
each other takes the other branch in one framework, and the gradient jumps
(7e-2 at the input, against 7.5e-14 in float64).
"""

import numpy as np
import pytest
import torch

from betty_tpu.models import darts as J
from betty_tpu_torch.models import darts as T
from torch_darts_common import assert_within, compare, one_thread, with_stats

DTYPES = [torch.float32, torch.float64]
IDS = ["f32", "f64"]
F32_TOL = 1e-4

one_thread = pytest.fixture(autouse=True)(one_thread)


def _images(n, hw, seed=0):
    return np.random.RandomState(seed).randn(n, hw, hw, 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_eval_network_matches_flax(train, dtype):
    net = with_stats(T.DARTSEvalNetwork(T.DARTS_V2, channels=4, layers=6, auxiliary=True))
    errs = compare(J.DARTSEvalNetwork(J.DARTS_V2, channels=4, layers=6, auxiliary=True), net,
                   [_images(8, 32)], dtype, extra=[0.0], train=train, nchw=False)
    assert ("out 1" in errs) == train  # the auxiliary logits, train mode only
    if dtype == torch.float64:
        assert_within(errs, dtype)
    else:
        outs = {k: v for k, v in errs.items() if not k.startswith("grad")}
        worst = max(outs, key=outs.get)
        assert outs[worst] <= F32_TOL, (worst, outs[worst], F32_TOL)
