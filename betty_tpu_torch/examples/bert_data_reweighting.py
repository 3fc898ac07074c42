"""BERT/RoBERTa-style data reweighting (the north-star workload).

Port of ``examples/bert_data_reweighting/main.py``: a Meta-Weight-Net
reweighter above a transformer classifier trained on an imbalanced
synthetic SST-2-like task, with ``--hypergradient sama`` (or darts, cg,
neumann), bf16 precision and ``--unroll_steps 5`` by default. ``--model
large`` is the RoBERTa-large shape (24 layers, d 1024, 16 heads, about 355M
parameters); ``--flash`` routes attention through the port's CUDA kernels
(darts and SAMA only: CG and Neumann differentiate through the gradient and
run the plain attention). ``build_engine(args, **solver_config)`` passes
further ``Config`` fields (``cg_iterations``, ``use_fused_vector_ops``, ...)
to the classifier, whose config chooses the hypergradient solver.

    python -m betty_tpu_torch.examples.bert_data_reweighting --model large --flash

Weights are random, made from a seed. ``--compile_blocks`` runs the steady
schedule as compiled blocks (on CUDA one graph replay a meta-period).
``--remat`` recomputes each encoder block in the backward, under
``--remat_policy`` ``full`` (with ``--flash`` the flash kernel's residuals
are kept and B1/B3 is not replayed), ``minimal`` (everything replayed, the
flash forward included) or ``dots`` (matmul outputs kept); see
``models/transformer.py``. ``--checkpoint_dir`` saves an engine checkpoint
whenever the dev accuracy improves (``SST2Engine.validation``; the
synthetic data has no dev split, so set ``engine.dev_data``).
``--strategy dp|distributed|zero|fsdp`` runs one process a rank
(``torchrun --nproc_per_node N -m betty_tpu_torch.examples.bert_data_reweighting
--strategy fsdp``, or the ``BETTY_*`` variables), each rank loading
``--batch_size`` examples; ``--mesh dcn:2,dp:4`` lays the ranks out. The
classifier's loss divides by the global batch's weight sum
(``parallel.global_divisor`` of the local sum), so the mean of the ranks'
losses is the one-process loss of the global batch. ``--strategy tp
--mesh dp:2,mdl:4`` (the JAX example's ``main.py:341-346``) shards the
classifier over the ``mdl`` axis by the Megatron rules (attention on a
rank's heads, the MLP column- then row-parallel; ``parallel.tp_shardings``),
each of the ``dp`` ranks loading ``--batch_size`` examples:

    torchrun --nproc_per_node 4 -m betty_tpu_torch.examples.bert_data_reweighting \
        --model large --flash --strategy tp --mesh mdl:4

Not ported yet: real SST-2 (``--data-dir``) and HuggingFace checkpoints
(``--hf_model``).
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples.vision_data import problem_accuracy
from betty_tpu_torch.models import MetaWeightNet, TransformerClassifier, roberta_large_config
from betty_tpu_torch.module import from_torch


def make_synthetic_sst2(n, seq_len, vocab, seed=0, imbalance=10, signal=1.0):
    """Imbalanced binary classification over token sequences (the JAX
    example's generator, draw for draw). ``signal=1.0``: a class token at
    position 0; ``signal < 1``: every token drawn from the label's half of
    the vocabulary with probability ``signal``."""
    rng = np.random.RandomState(seed)
    n_pos = n // (imbalance + 1)
    labels = np.concatenate([np.ones(n_pos), np.zeros(n - n_pos)]).astype(np.int32)
    rng.shuffle(labels)
    if signal >= 1.0:
        ids = rng.randint(2, vocab, size=(n, seq_len)).astype(np.int32)
        ids[:, 0] = np.where(labels == 1, 5, 7)
        return ids, labels
    half = (vocab - 2) // 2
    own_half = rng.rand(n, seq_len) < signal
    pos_half = own_half == (labels == 1)[:, None]
    offs = rng.randint(0, half, size=(n, seq_len))
    ids = np.where(pos_half, 2 + offs, 2 + half + offs).astype(np.int32)
    return ids, labels


class Reweight(ImplicitProblem):
    def training_step(self, batch):
        input_ids, labels = batch
        logits = self.classifier(input_ids)
        loss = F.cross_entropy(logits, labels.long())
        acc = (logits.argmax(dim=1) == labels).float().mean() * 100
        return {"loss": loss, "acc": acc}


class Classifier(ImplicitProblem):
    def training_step(self, batch):
        input_ids, labels = batch
        logits = self.module(input_ids)
        ce = F.cross_entropy(logits, labels.long(), reduction="none")
        weight = self.reweight(ce.detach())
        # the global batch's weight sum, held at 1e-8 or more
        return torch.sum(weight * ce) / parallel.global_divisor(torch.sum(weight), least=1e-8)


class SST2Engine(Engine):
    """Dev-accuracy validation (when a dev set exists), saving a checkpoint
    into ``checkpoint_dir`` on each improvement."""

    dev_data = None
    checkpoint_dir = None
    eval_batch = 256
    best_acc = -1.0

    def validation(self):
        if self.dev_data is None:
            return {}
        x, y = self.dev_data
        acc = problem_accuracy(self.classifier, x, y, batch=self.eval_batch)
        if acc > self.best_acc:
            self.best_acc = acc
            if self.checkpoint_dir:
                self.save_checkpoint(self.checkpoint_dir)
        return {"acc": acc, "best_acc": self.best_acc}


def build_engine(args, **solver_config):
    vocab = 1000 if args.model == "small" else 50265
    device = torch.device(args.device)
    if args.strategy != "default" or args.mesh:
        parallel.maybe_init_distributed(device)  # this rank's card, before anything is built
    x_train, y_train = make_synthetic_sst2(args.train_size, args.seq_len, vocab, seed=0,
                                           imbalance=args.imbalance, signal=args.signal)
    x_meta, y_meta = make_synthetic_sst2(args.meta_size, args.seq_len, vocab, seed=1,
                                         imbalance=1, signal=args.signal)
    if args.flash and args.hypergradient in ("cg", "neumann"):
        raise ValueError("--flash runs reverse-mode-only kernels; CG/Neumann need the "
                         "plain attention — drop --flash or use darts/sama")
    policy = None if args.remat_policy == "full" else args.remat_policy
    if args.model == "large":
        model = roberta_large_config(max_len=args.seq_len, use_flash=args.flash,
                                     dropout=args.dropout, remat=args.remat,
                                     remat_policy=policy, device=device, seed=0)
    else:
        model = TransformerClassifier(vocab_size=vocab, max_len=args.seq_len, dim=args.dim,
                                      depth=args.depth, heads=args.heads, use_flash=args.flash,
                                      dropout=args.dropout, remat=args.remat,
                                      remat_policy=policy, device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    mwn = MetaWeightNet(device=device, generator=gen)
    loader_device = device if args.device_data else False

    reweight = Reweight(
        name="reweight",
        module=from_torch(mwn),
        optimizer=optim.adam(lr=args.meta_lr),
        train_data_loader=ArrayLoader(x_meta, y_meta, batch_size=args.batch_size, seed=1,
                                      device=loader_device),
        config=Config(type=args.hypergradient, precision=args.precision,
                      solver_precision=args.solver_precision, log_step=args.log_step),
    )
    classifier = Classifier(
        name="classifier",
        module=from_torch(model),
        optimizer=optim.adamw(lr=args.lr, weight_decay=0.01),
        train_data_loader=ArrayLoader(x_train, y_train, batch_size=args.batch_size, seed=0,
                                      device=loader_device),
        config=Config(type=args.hypergradient, unroll_steps=args.unroll_steps,
                      precision=args.precision, solver_precision=args.solver_precision,
                      log_step=args.log_step, **solver_config),
    )
    engine = SST2Engine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                            strategy=args.strategy, compile_blocks=args.compile_blocks,
                            mesh_shape=parallel.mesh_shape(args.mesh)),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )
    engine.checkpoint_dir = args.checkpoint_dir
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--hypergradient", default="sama", choices=["sama", "darts", "cg", "neumann"],
                   help="hypergradient solver (cg and neumann need the plain attention)")
    p.add_argument("--precision", default="bf16", choices=["fp32", "bf16"])
    p.add_argument("--solver_precision", default="fp32", choices=["fp32", "bf16"],
                   help="precision of the hypergradient pipeline")
    p.add_argument("--strategy", default="default",
                   choices=["default", "dp", "distributed", "zero", "fsdp", "tp"],
                   help="strategy over torch.distributed (one process a rank): data "
                        "parallel, or tp (Megatron tensor parallelism over a 'mdl' axis)")
    p.add_argument("--mesh", default=None,
                   help="rank layout as 'name:size,...', e.g. 'dcn:2,dp:4' or 'dp:2,mdl:4' "
                        "(default: every rank on dp)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--meta_lr", type=float, default=1e-4)
    p.add_argument("--unroll_steps", type=int, default=5)
    p.add_argument("--imbalance", type=int, default=10)
    p.add_argument("--signal", type=float, default=1.0)
    p.add_argument("--train_size", type=int, default=2048)
    p.add_argument("--meta_size", type=int, default=512)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--valid_step", type=int, default=1000)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--flash", action="store_true",
                   help="attention through the CUDA kernels (darts/sama only)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the encoder blocks in the backward (torch.utils.checkpoint)")
    p.add_argument("--remat_policy", default="full", choices=["full", "minimal", "dots"],
                   help="with --remat: 'full' recomputes each block (with --flash the flash "
                        "residuals are kept, so B1/B3 is not replayed); 'minimal' recomputes "
                        "everything, the flash forward included; 'dots' keeps every matmul "
                        "output and recomputes the elementwise math")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device_data", action="store_true",
                   help="keep the datasets on the device and gather batches there")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="save an engine checkpoint on validation improvement")
    return p.parse_args(argv)


if __name__ == "__main__":
    build_engine(parse_args()).run()
