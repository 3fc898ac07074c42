"""The tutorial series (``tutorial/`` of the JAX package), ported: 1 quick
start, 2 validation, 3 logging, 4 memory and precision, 6 performance, 8 a
custom hypergradient solver. Run one as

    python -m betty_tpu_torch.tutorial.1_quick_start            # on cuda
    python -m betty_tpu_torch.tutorial.1_quick_start --device cpu
"""
