"""The CUDA kernels against their plain versions on the card. Imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

Skips without a CUDA device; chip_smoke.py runs the full comparison at the
slice's shape."""

import numpy as np
import pytest
import torch

from betty_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 96, 16


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), bool)
    mask[0, S - 20:] = False
    return q, k, v, w, mask


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the full comparison there")
    q, k, v, w, mask = _inputs(5)
    dev = torch.device("cuda")
    args = [torch.tensor(x, device=dev) for x in (q, k, v)]
    tm = torch.tensor(mask, device=dev)
    o, lse = tfa._fwd_single(*args, tm, causal=False, sm_scale=0.25)
    po, plse = tfa._fwd_single_plain(*args, tm, causal=False, sm_scale=0.25)
    torch.testing.assert_close(o, po, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)
    do = torch.tensor(w, device=dev)
    got = tfa._bwd_single(*args, do, o, lse, tm, causal=False, sm_scale=0.25)
    want = tfa._bwd_single_plain(*args, do, po, plse, tm, causal=False, sm_scale=0.25)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)
