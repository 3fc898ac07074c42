"""Tutorial 7: model parallelism (``tutorial/7_model_parallelism.py``).

Tutorial 5 split the batch over the ranks (dp/zero/fsdp). When one model,
or the second-order solver state around it, outgrows a card, the port also
splits the model, with one config line:

* ``--mode tp``  Megatron tensor parallelism (``strategy="tp"``): the
                 attention heads column- then row-parallel, the MLP
                 column- then row-parallel, the other large leaves
                 gathered where they are used, over the ``mdl`` mesh axis;
                 ``Config.shard_rules`` pins a leaf's layout.
* ``--mode pp``  GPipe pipelining and ``--mode sp`` sequence parallelism
                 are ROADMAP.md §A.7's remaining slice: they raise.

Expert parallelism (``strategy="ep"``) is ``examples/moe_reweighting.py
--strategy ep``.

The program is the JAX tutorial's: a transformer classifier (VOCAB 256,
LEN 16, DIM 64, DEPTH 4, HEADS 4) reweighted by a Meta-Weight-Net under
darts, on random tokens, a global batch of 32 a step on a ``dp:2,mdl:4``
mesh: each of the 2 ``dp`` ranks loads its 16 rows of the global batch
(every other row),
and the 4 ranks of its model group split the heads and the MLP. One
process a rank (gloo on the CPU, NCCL on the card; ``--backend`` picks
another):

    torchrun --nproc_per_node 8 -m betty_tpu_torch.tutorial.7_model_parallelism \\
        --device cpu --mode tp

``--mesh none`` runs the same program in one process on the global batch.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.models import MetaWeightNet, TransformerClassifier
from betty_tpu_torch.module import from_torch
from betty_tpu_torch.parallel.mesh import model_parallel_error
from betty_tpu_torch.utils import require_device

VOCAB, LEN, DIM, DEPTH, HEADS = 256, 16, 64, 4, 4
BATCH = 32  # the global batch


def loader(seed, mesh_spec):
    """The JAX tutorial's batches (``RandomState(seed)``, token ids and
    labels of the global batch), this rank's rows ``index::count`` of each
    (the rows ``data.shard_loader`` gives a rank, and the rows of the
    global dropout masks it keeps, ``parallel.local_rows``)."""
    index, count = parallel.batch_coordinates(parallel.mesh_shape(mesh_spec)) if mesh_spec else (0, 1)
    rows = slice(index, None, count)
    r = np.random.RandomState(seed)
    while True:
        ids = r.randint(2, VOCAB, size=(BATCH, LEN)).astype(np.int32)
        y = r.randint(0, 2, size=BATCH).astype(np.int32)
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
    if args.mode != "tp":
        raise model_parallel_error(f"tutorial 7 --mode {args.mode}")
    mesh = None if args.mesh in (None, "", "none") else args.mesh
    if mesh:
        parallel.maybe_init_distributed(device, backend=args.backend)
    classifier = Classifier(
        name="classifier",
        module=from_torch(TransformerClassifier(vocab_size=VOCAB, max_len=LEN, dim=DIM,
                                                depth=DEPTH, heads=HEADS, num_classes=2,
                                                dropout=args.dropout, device=device, seed=0)),
        optimizer=optim.adamw(lr=1e-4),
        train_data_loader=loader(0, mesh),
        config=Config(type="darts", unroll_steps=1),
    )
    reweight = Reweight(
        name="reweight",
        module=from_torch(MetaWeightNet(device=device, generator=torch.Generator(
            device=device).manual_seed(1))),
        optimizer=optim.adam(lr=1e-4),
        train_data_loader=loader(1, mesh),
        config=Config(type="darts", log_step=10),
    )
    return Engine(
        # the loaders cut the global batch themselves
        config=EngineConfig(train_iters=args.train_iters,
                            strategy="tp" if mesh else "default",
                            mesh_shape=parallel.mesh_shape(mesh), autoshard_data=False),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="tp", choices=["tp", "pp", "sp"])
    p.add_argument("--train_iters", type=int, default=20)
    p.add_argument("--mesh", default="dp:2,mdl:4",
                   help="rank layout ('none': one process, the global batch)")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    params = engine.states["classifier"]["params"]
    dims = engine.classifier._shard_dims.get("params", {})
    sharded = sum(1 for d in dims.values() if d is not None)
    name = "blocks.0.attn.query.kernel"
    if engine.is_rank_zero():
        print(f"mode={engine.strategy}: {sharded} of {len(params)} parameter leaves "
              f"model-sharded; {name} held {tuple(params[name].shape)} (dim {dims.get(name)})")
    return engine


if __name__ == "__main__":
    main()
