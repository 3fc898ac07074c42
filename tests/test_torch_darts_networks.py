"""The port's DARTS supernet ``DARTSNetwork`` at C4 L3 (a normal cell, then
two reductions, the second after the first) against flax's
(``betty_tpu/models/darts.py``) on the same numpy-seeded images, with the
port's weights carried to flax (``torch_darts_common.check_supernet``), in
float32 within 1e-5: logits, the new running statistics of its 359
BatchNorms, the gradients to the params and to both alphas (train mode),
and eval-mode logits on the running statistics.

flax runs op by op here (compiling the whole supernet takes XLA minutes on
the CPU), at 16x16 images. The float64 cases are in
``test_torch_darts_networks_float64.py``, the evaluation network in
``test_torch_darts_eval_network.py``.
"""

import pytest
import torch

from torch_darts_common import check_supernet, one_thread

one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_supernet_matches_flax(train):
    check_supernet(train, torch.float32)
