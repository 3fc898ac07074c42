"""A Switch MoE classifier under a Meta-Weight-Net reweighter.

The one-device bilevel program of the JAX package's
``tests/test_ep.py::test_bilevel_engine_with_expert_parallel_moe`` (its
unsharded run): the ``inner`` problem is a Switch top-1 MoE feed-forward
layer (``models/moe.py``) with a residual and a linear two-class head,
trained by SGD 0.05 on the mean of its per-token cross-entropies weighted
by the ``outer`` problem's ``MetaWeightNet`` (plus 0.01 times the Switch
load-balancing loss); ``outer`` takes the inner model's cross-entropy on
held-out tokens through darts (unroll 2) and Adam 1e-3.

The defaults are the widths of the published Switch-Base-8
(``google/switch-base-8``; Fedus et al., arXiv:2101.03961): d_model 768,
d_ff 3072, 8 experts, capacity factor 1.25, on 4,096 tokens a step (B32 x
S128) for either problem. ``--dense`` routes every token to its expert
(capacity = the call's token count, ``moe_ffn_dense``), as the JAX test
does. The data are standard normal tokens with random binary labels, drawn
from ``np.random.RandomState(0)`` in the JAX test's order (train
tokens, labels, held-out tokens, labels, then the head's weights); the
MoE's weights come from a ``torch.Generator`` seeded with 0, the
reweighter's from one seeded with 1. The batches live on the device.

    python -m betty_tpu_torch.examples.moe_reweighting --device cpu --dim 16 --hidden 32 \\
        --experts 4 --tokens 64 --val_tokens 32 --dense --train_iters 4

``--precision bf16`` runs both problems' steps in bfloat16 (the routing
bookkeeping stays float32); ``--compile_blocks`` runs the steady schedule as
compiled blocks.
"""

import argparse
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim
from betty_tpu_torch.models.mlp import MetaWeightNet
from betty_tpu_torch.models.moe import init_moe_params, moe_ffn, moe_ffn_dense
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.utils import require_device


def make_data(tokens, val_tokens, dim):
    """``((x, y), (xv, yv), head)`` as numpy arrays, drawn in the JAX test's
    order."""
    rng = np.random.RandomState(0)
    x = rng.randn(tokens, dim).astype(np.float32)
    y = rng.randint(0, 2, tokens).astype(np.int64)
    xv = rng.randn(val_tokens, dim).astype(np.float32)
    yv = rng.randint(0, 2, val_tokens).astype(np.int64)
    head = (0.1 * rng.randn(dim, 2)).astype(np.float32)
    return (x, y), (xv, yv), head


CAPACITY_FACTOR = 1.25  # Switch-Base-8's


def classifier(params, tokens, dense=False):
    """``((tokens + moe(tokens)) @ out, aux)``."""
    if dense:
        h, aux = moe_ffn_dense(params["moe"], tokens)
    else:
        h, aux = moe_ffn(params["moe"], tokens, capacity_factor=CAPACITY_FACTOR)
    return (tokens + h) @ params["out"], aux


class Inner(ImplicitProblem):
    def training_step(self, batch):
        x, y = batch
        logits, aux = self.module(x)
        ce = F.cross_entropy(logits, y, reduction="none")
        w = self.outer(ce.detach())
        return torch.mean(w * ce) + 0.01 * aux


class Outer(ImplicitProblem):
    def training_step(self, batch):
        x, y = batch
        logits, _ = self.inner(x)
        return F.cross_entropy(logits, y)


def build_engine(args):
    device = require_device(args.device, "moe_reweighting")
    (x, y), (xv, yv), head = make_data(args.tokens, args.val_tokens, args.dim)
    moe = init_moe_params(torch.Generator(device=device).manual_seed(0), args.dim, args.hidden,
                          args.experts, device=device)

    def on_device(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    inner = Inner(
        name="inner",
        module=from_fn(partial(classifier, dense=args.dense),
                       {"moe": moe, "out": torch.from_numpy(head).to(device)}),
        optimizer=optim.sgd(lr=0.05),
        train_data_loader=[on_device(x, y)],
        config=Config(type="darts", unroll_steps=2, precision=args.precision),
    )
    outer = Outer(
        name="outer",
        module=from_torch(MetaWeightNet(device=device, generator=torch.Generator(
            device=device).manual_seed(1))),
        optimizer=optim.adam(lr=1e-3),
        train_data_loader=[on_device(xv, yv)],
        config=Config(precision=args.precision),
    )
    return Engine(
        config=EngineConfig(train_iters=args.train_iters, compile_blocks=args.compile_blocks),
        problems=[outer, inner],
        dependencies={"u2l": {outer: [inner]}, "l2u": {inner: [outer]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dim", type=int, default=768, help="d_model")
    p.add_argument("--hidden", type=int, default=3072, help="d_ff of each expert")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--dense", action="store_true",
                   help="every token to its expert, none dropped (capacity = tokens)")
    p.add_argument("--tokens", type=int, default=4096, help="tokens of a classifier step")
    p.add_argument("--val_tokens", type=int, default=4096, help="tokens of a reweighter step")
    p.add_argument("--train_iters", type=int, default=4)
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    return engine


if __name__ == "__main__":
    main()
