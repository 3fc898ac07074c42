"""The port's DARTS supernet ``DARTSNetwork`` at C4 L3 against flax's in
float64 within 1e-10 (``torch_darts_common.check_supernet``): logits, the
new running statistics of its 359 BatchNorms, the gradients to the params
and to both alphas (train mode), and eval-mode logits on the running
statistics. The float32 cases are in ``test_torch_darts_networks.py``.
"""

import pytest
import torch

from torch_darts_common import check_supernet, one_thread

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_supernet_matches_flax_in_float64(train):
    check_supernet(train, torch.float64)
