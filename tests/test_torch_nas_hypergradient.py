"""One darts hypergradient of the DARTS search at C4 L3 (a normal cell, a
reduction, a reduction after a reduction): ``betty_tpu``'s darts solver and
the port's on the same states and batches in float64, after the same
starting vector v (``torch_nas_impl.py hypergradient``, in a subprocess,
about 70 s): v and the hypergradient to the alphas within 1e-8 (measured
about 1.5e-13). The whole search program at L1 is in
``test_torch_nas.py``."""

from torch_darts_common import run_nas_impl


def test_darts_hypergradient_matches_jax_at_three_cells():
    run_nas_impl("hypergradient")
