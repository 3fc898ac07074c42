"""Robust NAS on the DARTS supernet (C2 L1 B2, float64): the classifier's
loss with the input-Jacobian term on, its gradients to the supernet's
parameters and to the alphas, and the running statistics its first
forward keeps, held to the JAX package's within 1e-8
(``torch_robust_impl.py darts_jacobian``, in a subprocess; JAX's
direction injected).

A whole meta-period of JAX's second-order supernet takes minutes on the
CPU (op by op or compiled by XLA), so the supernet is held at the loss and
its gradients; the program runs whole on the ``mlp`` backbone
(``test_torch_robust_nas.py``) and on the card (``chip_smoke.py``'s
robust phase). CURE's in ``test_torch_robust_nas_darts_cure.py``.
"""

from torch_darts_common import run_robust_impl


def test_regularized_supernet_loss_matches_jax_in_float64():
    lines = run_robust_impl(["darts_jacobian"])["darts_jacobian"]
    assert len(lines) == 1 and lines[0].startswith("OK "), lines
