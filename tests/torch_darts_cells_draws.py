"""The float32 errors of the DARTS cells over many weight draws: for each
cell of test_torch_darts_cells.py and each seed, the port's worst float32
error and the JAX package's own, both against flax in float64 on the same
draw (``torch_darts_common.float32_errors``), their ratio, and the port's
difference from JAX's float32 run (the check the cells were held to
before, at 1e-5). The distribution sets ``F32_JAX_MULTIPLE``.

    JAX_PLATFORMS=cpu python tests/torch_darts_cells_draws.py KIND FIRST LAST

KIND ``normal``, ``reduction`` or ``after_reduction``; seeds FIRST to
LAST - 1. One JSON line a draw; run a few KINDs or seed ranges side by
side (about a minute a draw on one CPU thread).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def main(kind, first, last):
    import numpy as np
    import torch

    from betty_tpu.models import darts as J
    from betty_tpu_torch.models import darts as T
    from test_torch_darts_cells import CELLS, _images
    from torch_darts_common import compare, float32_errors

    torch.set_num_threads(1)
    reduction, reduction_prev = CELLS[kind]
    c, c_pp, c_p = 2, 6, 8
    hw0 = 16 if reduction_prev else 8
    weights = np.random.RandomState(4).rand(T.NUM_EDGES, len(T.PRIMITIVES))
    inputs = [_images((2, hw0, hw0, c_pp), 1), _images((2, 8, 8, c_p), 2)]
    for seed in range(first, last):
        net = T.Cell(c_pp, c_p, c, reduction, reduction_prev,
                     generator=torch.Generator().manual_seed(seed))
        port, own = float32_errors(J.Cell(c, reduction, reduction_prev), net, inputs,
                                   extra=[weights])
        old = compare(J.Cell(c, reduction, reduction_prev), net, inputs, torch.float32,
                      extra=[weights])
        wp, wj, wo = (max(e, key=e.get) for e in (port, own, old))
        print(json.dumps({"kind": kind, "seed": seed, "port": port[wp], "port_at": wp,
                          "jax": own[wj], "jax_at": wj, "ratio": port[wp] / own[wj],
                          "against_jax_f32": old[wo], "against_jax_f32_at": wo}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
