"""Tutorial 7: model parallelism (``tutorial/7_model_parallelism.py``).

Tutorial 5 split the batch over the ranks (dp/zero/fsdp). When one model,
or the second-order solver state around it, outgrows a card, the port also
splits the model, with one config line:

* ``--mode tp``  Megatron tensor parallelism (``strategy="tp"``): the
                 attention heads column- then row-parallel, the MLP
                 column- then row-parallel, the other large leaves
                 gathered where they are used, over the ``mdl`` mesh axis;
                 ``Config.shard_rules`` pins a leaf's layout.
* ``--mode pp``  GPipe pipelining: ``models.make_pipelined_transformer``
                 stacks the encoder blocks on a leading depth axis, which
                 ``Config.shard_rules=((r"^blocks", ("pp",)),)`` shards
                 over the ``pp`` axis under ``strategy="tp"``; 4
                 microbatches flow through the stages by ring shifts, and
                 every hypergradient solver differentiates through the
                 pipeline. On a mesh with a ``mdl`` axis too
                 (``--mesh dp:2,mdl:2,pp:2``, the JAX package's ``dp x mdl
                 x pp``) each stage computes Megatron tensor parallelism
                 over ``mdl``, its leaves cut on two dims by
                 ``models.COMPOSED_SHARD_RULES`` (the stage dim over
                 ``pp``, heads and MLP columns over ``mdl``).
* ``--mode sp``  sequence parallelism: the same module built with
                 ``seq_axis="sp"`` splits its activations on the sequence
                 over the ``sp`` axis (LayerNorm and the MLP on a rank's
                 positions, attention against the keys and values gathered
                 whole), under ``strategy="dp"``.

Expert parallelism (``strategy="ep"``) is ``examples/moe_reweighting.py
--strategy ep``.

The program is the JAX tutorial's: a transformer classifier (VOCAB 256,
LEN 16, DIM 64, DEPTH 4, HEADS 4) reweighted by a Meta-Weight-Net under
darts, on random tokens, a global batch of 32 a step on a ``dp:2,mdl:4``
mesh (``dp:2,pp:4`` for pp, ``dp:2,sp:4`` for sp): each of the 2 ``dp``
ranks loads its 16 rows of the global batch (every other row), and the 4
ranks of its model group split the heads and the MLP (the stages, the
sequence). One process a rank (gloo on the CPU, NCCL on the card;
``--backend`` picks another):

    torchrun --nproc_per_node 8 -m betty_tpu_torch.tutorial.7_model_parallelism \\
        --device cpu --mode tp          # or --mode pp, --mode sp

``--mesh`` sets another layout (``--mesh dp:1,pp:2``, ``--mesh
dp:1,mdl:2,pp:2`` for pp on two model axes), ``--mesh none``
runs the same program in one process on the global batch. The widths
(``--vocab_size``, ``--seq_len``, ``--dim``, ``--depth``, ``--heads``), the
global batch and the microbatches are options; the defaults are the JAX
tutorial's.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.models import (MetaWeightNet, TransformerClassifier,
                                   make_pipelined_transformer, pipelined_shard_rules)
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.utils import require_device

VOCAB, LEN, DIM, DEPTH, HEADS = 256, 16, 64, 4, 4
BATCH = 32  # the global batch
MESHES = {"tp": "dp:2,mdl:4", "pp": "dp:2,pp:4", "sp": "dp:2,sp:4"}


def loader(seed, mesh_spec, batch=BATCH, vocab=VOCAB, length=LEN):
    """The JAX tutorial's batches (``RandomState(seed)``, token ids and
    labels of the global batch), this rank's rows ``index::count`` of each
    (the rows ``data.shard_loader`` gives a rank, and the rows of the
    global dropout masks it keeps, ``parallel.local_rows``)."""
    index, count = parallel.batch_coordinates(parallel.mesh_shape(mesh_spec)) if mesh_spec else (0, 1)
    rows = slice(index, None, count)
    r = np.random.RandomState(seed)
    while True:
        ids = r.randint(2, vocab, size=(batch, length)).astype(np.int32)
        y = r.randint(0, 2, size=batch).astype(np.int32)
        yield ids[rows], y[rows]


class Classifier(ImplicitProblem):
    def training_step(self, batch):
        ids, y = batch
        ce = F.cross_entropy(self.module(ids), y.long(), reduction="none")
        w = self.reweight(ce.detach())
        return torch.mean(w * ce)


class Reweight(ImplicitProblem):
    def training_step(self, batch):
        ids, y = batch
        return F.cross_entropy(self.classifier(ids), y.long())


def build_engine(args):
    device = require_device(args.device, "tutorial 7")
    mesh = MESHES[args.mode] if args.mesh is None else args.mesh
    mesh = None if mesh in ("", "none") else mesh
    if mesh:
        parallel.maybe_init_distributed(device, backend=args.backend)
    widths = dict(vocab_size=args.vocab_size, max_len=args.seq_len, dim=args.dim,
                  depth=args.depth, heads=args.heads, num_classes=2)
    clf_config = Config(type="darts", unroll_steps=1)
    strategy = "tp"
    if args.mode == "tp":
        # Megatron rules pick the layouts
        module = from_torch(TransformerClassifier(**widths, dropout=args.dropout, device=device,
                                                  seed=0))
    elif args.mode == "pp":
        module = make_pipelined_transformer(parallel.mesh_shape(mesh), **widths, seed=0,
                                            num_microbatches=args.num_microbatches,
                                            device=device)
        # the stage-stacked blocks (a leading depth axis) sharded over pp,
        # and beside a mdl axis their heads and MLP columns over mdl
        clf_config = Config(type="darts", unroll_steps=1,
                            shard_rules=pipelined_shard_rules(parallel.mesh_shape(mesh)))
    else:  # sp: parameters replicated, activations split on the sequence
        module = make_pipelined_transformer(parallel.mesh_shape(mesh), **widths, seed=0,
                                            seq_axis="sp", device=device)
        strategy = "dp"
    data = dict(batch=args.batch_size, vocab=args.vocab_size, length=args.seq_len)
    classifier = Classifier(
        name="classifier",
        module=module,
        optimizer=optim.adamw(lr=1e-4),
        train_data_loader=loader(0, mesh, **data),
        config=clf_config,
    )
    reweight = Reweight(
        name="reweight",
        module=from_torch(MetaWeightNet(device=device, generator=torch.Generator(
            device=device).manual_seed(1))),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=loader(1, mesh, **data),
        config=Config(type="darts", log_step=10),
    )
    return Engine(
        # the loaders cut the global batch themselves
        config=EngineConfig(train_iters=args.train_iters,
                            strategy=strategy if mesh else "default",
                            mesh_shape=parallel.mesh_shape(mesh), autoshard_data=False),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="tp", choices=["tp", "pp", "sp"])
    p.add_argument("--train_iters", type=int, default=20)
    p.add_argument("--mesh", default=None,
                   help="rank layout (default dp:2,mdl:4 / dp:2,pp:4 / dp:2,sp:4 by mode; "
                        "'none': one process, the global batch)")
    p.add_argument("--dropout", type=float, default=0.1, help="tp mode's dropout")
    p.add_argument("--vocab_size", type=int, default=VOCAB)
    p.add_argument("--seq_len", type=int, default=LEN)
    p.add_argument("--dim", type=int, default=DIM)
    p.add_argument("--depth", type=int, default=DEPTH)
    p.add_argument("--heads", type=int, default=HEADS)
    p.add_argument("--batch_size", type=int, default=BATCH, help="the global batch")
    p.add_argument("--num_microbatches", type=int, default=4, help="pp mode's M")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    engine.run()
    params = engine.states["classifier"]["params"]
    dims = engine.classifier._shard_dims.get("params", {})
    sharded = sum(1 for d in dims.values() if d is not None)
    name = next(k for k in ("blocks.0.attn.query.kernel", "blocks.attn.query.kernel")
                if k in params)
    if engine.is_rank_zero():
        print(f"mode={args.mode} (strategy {engine.strategy}): {sharded} of {len(params)} parameter leaves "
              f"model-sharded; {name} held {tuple(params[name].shape)} (dim {dims.get(name)})")
    return engine


if __name__ == "__main__":
    main()
