"""Tutorial 6: the performance path (``tutorial/6_performance.py``).

Driver mode dispatches every step's kernels from Python, so once a step
is fast the host's launch rate bounds it. Three one-line dials remove that:

1. ``EngineConfig(compile_blocks=True)``: the engine simulates the step
   recursion once (``unroll_steps``, ``gradient_accumulation`` and
   ``roll_back`` are static), captures one steady meta-period as a CUDA
   graph and replays it once a period (``betty_tpu_torch/compile.py``).
2. ``ArrayLoader(..., device=...)``: the dataset lives in device memory; a
   compiled period is fed its batches' index rows only, and gathers the
   batches on the device inside the graph.
3. ``Config(precision="bf16")``: the steps compute in bfloat16 while the
   hypergradients stay float32 (``solver_precision``).

``run_all`` times the tutorial's four configurations, each from a fresh
engine, with ``torch.cuda.synchronize()`` around the run on the card
(the capture included), and prints meta-steps per second.

    python -m betty_tpu_torch.tutorial.6_performance              # on cuda
    python -m betty_tpu_torch.tutorial.6_performance --device cpu --train_iters 32
"""

import argparse
import time

import torch

from betty_tpu_torch import Config, Engine, EngineConfig, optim
from betty_tpu_torch.tutorial.common import (Classifier, Loader, Reweight, classifier_module,
                                             make_imbalanced_mnist, reweight_module)
from betty_tpu_torch.utils import require_device

TRAIN_ITERS = 512
CONFIGS = [  # name: (compile_blocks, device_data, precision)
    ("driver, host data, fp32", (False, False, "fp32")),
    ("blocks, host data, fp32", (True, False, "fp32")),
    ("blocks, device data, fp32", (True, True, "fp32")),
    ("blocks, device data, bf16", (True, True, "bf16")),
]


def build(compile_blocks, device_data, precision, device="cuda", train_iters=TRAIN_ITERS):
    device = require_device(device, "tutorial 6")
    x_train, y_train = make_imbalanced_mnist(imbalance=20, seed=0)
    x_meta, y_meta = make_imbalanced_mnist(n=256, imbalance=1, seed=1)
    data_device = device if device_data else False
    classifier = Classifier(
        name="classifier",
        module=classifier_module(64, device=device),
        optimizer=optim.sgd(lr=0.1, momentum=0.9),
        train_data_loader=Loader(x_train, y_train, 64, device=data_device),
        config=Config(type="darts", unroll_steps=1, precision=precision),
    )
    reweight = Reweight(
        name="reweight",
        module=reweight_module(64, device=device),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=Loader(x_meta, y_meta, 64, seed=1, device=data_device),
        config=Config(precision=precision),
    )
    return Engine(
        config=EngineConfig(train_iters=train_iters, compile_blocks=compile_blocks),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def timed_run(engine):
    """Seconds of ``engine.run()``, the card synchronised before and after."""
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    engine.run()
    sync()
    return time.perf_counter() - t0


def run_all(device="cuda", train_iters=TRAIN_ITERS):
    """``[(name, meta-steps/s, engine)]`` of the four configurations."""
    out = []
    for name, cfg in CONFIGS:
        engine = build(*cfg, device=device, train_iters=train_iters)
        rate = train_iters / timed_run(engine)
        print(f"{name:28s}: {rate:7.1f} meta-steps/s (incl. capture)")
        out.append((name, rate, engine))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_iters", type=int, default=TRAIN_ITERS)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run_all(args.device, args.train_iters)


if __name__ == "__main__":
    main()
