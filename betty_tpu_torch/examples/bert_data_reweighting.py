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
whenever the dev accuracy improves (``SST2Engine.validation``, which reads
the dev split that ``--data-dir`` loads; the synthetic data has none).
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

``--data-dir`` reads SST-2 (the JAX example's ``load_sst2`` and
``split_imbalanced``, array for array): a GLUE-style directory of
``train.tsv`` and ``dev.tsv`` (label and sentence in either column order,
header rows skipped) or an ``.npz`` of token ids ``x_train``, ``y_train``,
``x_dev``, ``y_dev``. The sentences go through the HuggingFace tokenizer
at ``<data-dir>/tokenizer`` when that directory exists and
``transformers`` loads it, else through ``hashed_tokenize`` (whitespace
words hashed by ``zlib.crc32``); the engine logs which one it used and
keeps its name in ``engine.tokenizer``. The train set is split into a
balanced meta set of ``--num_meta`` rows and a long-tail train set
(``--imbalance``); the dev set feeds ``validation``:

    python -m betty_tpu_torch.examples.bert_data_reweighting --model large --flash \
        --data-dir ~/glue/SST-2 --valid_step 500 --checkpoint_dir ckpt

``--donate`` (``EngineConfig.donate_state``) updates the parameters, the
Adam moments and the gradients in place, in driver mode and compiled, with
the same values; the state is then held once on the card, where a compiled
block otherwise keeps a second copy:

    python -m betty_tpu_torch.examples.bert_data_reweighting --model large --flash \
        --compile_blocks --donate

Left out: ``--hf_model`` (a HuggingFace Flax checkpoint through
``transformers``, which the card's machine does not have) and
``--rng_impl`` (JAX's PRNG choice; the port's streams are splitmix by
design).
"""

import argparse
import os
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.data import ArrayLoader
from betty_tpu_torch.examples.vision_data import problem_accuracy
from betty_tpu_torch.logging import get_logger
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


def hashed_tokenize(sentences, vocab, seq_len):
    """Token ids without a vocabulary file: lower-cased whitespace words
    hashed by ``zlib.crc32`` into ``[2, vocab)``, after a cls id 1, padded
    with 0 to ``seq_len`` (int32)."""
    ids = np.zeros((len(sentences), seq_len), np.int32)
    ids[:, 0] = 1
    for i, s in enumerate(sentences):
        for j, t in enumerate(str(s).lower().split()[:seq_len - 1]):
            ids[i, j + 1] = 2 + (zlib.crc32(t.encode()) % (vocab - 2))
    return ids


def _is_npz(data_dir):
    return os.path.isfile(data_dir) and data_dir.endswith(".npz")


def _read_tsv(path):
    """(sentences, int32 labels) of a TSV whose numeric label is in either
    column; rows without one (headers) are skipped."""
    labels, sents = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) != 2:
                continue
            if parts[0].strip().isdigit():  # label<TAB>sentence
                labels.append(int(parts[0]))
                sents.append(parts[1])
            elif parts[1].strip().isdigit():  # sentence<TAB>label (GLUE's order)
                labels.append(int(parts[1]))
                sents.append(parts[0])
    if not labels:
        raise ValueError(
            f"{os.path.basename(path)}: no parseable rows — expected TSV with a numeric "
            "label column in either position (header rows are skipped)")
    return sents, np.asarray(labels, np.int32)


def sst2_tokenizer(data_dir, vocab, seq_len):
    """``(name, tokenize)``: the HuggingFace tokenizer saved at
    ``<data_dir>/tokenizer`` when that directory exists and ``transformers``
    loads it (local files only), else ``hashed_tokenize``."""
    path = os.path.join(data_dir, "tokenizer")
    if os.path.isdir(path):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        except Exception as e:  # no transformers, or not a tokenizer directory
            get_logger().info(f"{path}: not loaded ({type(e).__name__}: {e})")
        else:
            def tokenize(sents):
                out = tok(sents, max_length=seq_len, padding="max_length", truncation=True)
                return np.asarray(out["input_ids"], np.int32)

            return f"huggingface:{path}", tokenize
    return "hashed", lambda sents: hashed_tokenize(sents, vocab, seq_len)


def load_sst2(data_dir, vocab, seq_len, tokenizer=None):
    """``(x_train, y_train, x_dev, y_dev)`` int32 arrays from an npz of
    token ids or a directory of ``train.tsv`` and ``dev.tsv``, tokenized by
    ``tokenizer`` (``sst2_tokenizer``'s pair; by default its choice)."""
    if _is_npz(data_dir):
        d = np.load(data_dir)
        return tuple(d[k].astype(np.int32) for k in ("x_train", "y_train", "x_dev", "y_dev"))
    _, tokenize = tokenizer or sst2_tokenizer(data_dir, vocab, seq_len)
    s_tr, y_tr = _read_tsv(os.path.join(data_dir, "train.tsv"))
    s_dev, y_dev = _read_tsv(os.path.join(data_dir, "dev.tsv"))
    return tokenize(s_tr), y_tr, tokenize(s_dev), y_dev


def split_imbalanced(x, y, imbalance_factor, num_meta_total=200, seed=1):
    """A balanced meta split of ``num_meta_total`` rows and a long-tail
    train subsample (class 1 cut by ``imbalance_factor``, each class
    truncated to what it has), both drawn from ``RandomState(seed)`` as the
    JAX example draws them."""
    rng = np.random.RandomState(seed)
    num_classes = 2
    num_meta = num_meta_total // num_classes
    sample_num = (len(y) - num_meta_total) // num_classes
    counts = [int(sample_num / imbalance_factor ** (c / (num_classes - 1)))
              for c in range(num_classes)]
    idx_meta, idx_train = [], []
    for c in range(num_classes):
        idx_c = np.flatnonzero(y == c)
        rng.shuffle(idx_c)
        idx_meta.extend(idx_c[:num_meta])
        idx_train.extend(idx_c[num_meta:][:counts[c]])
    idx_meta, idx_train = np.asarray(idx_meta), np.asarray(idx_train)
    rng.shuffle(idx_train)
    return x[idx_train], y[idx_train], x[idx_meta], y[idx_meta]


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
    """Dev-accuracy validation (when a dev set exists: ``--data-dir`` sets
    ``dev_data``), saving a checkpoint into ``checkpoint_dir`` on each
    improvement."""

    dev_data = None
    tokenizer = None
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
    dev_data = tokenizer = None
    if args.data_dir:
        # every rank loads the same split; the engine shards the loaders
        tokenizer = (None if _is_npz(args.data_dir) else
                     sst2_tokenizer(args.data_dir, vocab, args.seq_len))
        x_all, y_all, x_dev, y_dev = load_sst2(args.data_dir, vocab, args.seq_len, tokenizer)
        x_train, y_train, x_meta, y_meta = split_imbalanced(x_all, y_all, args.imbalance,
                                                            num_meta_total=args.num_meta)
        dev_data = (x_dev, y_dev)
        tokenizer = "token ids" if tokenizer is None else tokenizer[0]
        get_logger().info(f"SST-2 from {args.data_dir} ({tokenizer}): train rows per class "
                          f"{np.bincount(y_train, minlength=2).tolist()}, meta "
                          f"{np.bincount(y_meta, minlength=2).tolist()}, dev {len(y_dev)}")
    else:
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
                            donate_state=args.donate,
                            mesh_shape=parallel.mesh_shape(args.mesh)),
        problems=[reweight, classifier],
        dependencies={"u2l": {reweight: [classifier]}, "l2u": {classifier: [reweight]}},
        device=device,
    )
    engine.dev_data, engine.tokenizer = dev_data, tokenizer
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
    p.add_argument("--donate", action="store_true",
                   help="donate the state to the update (in place on the device: the "
                        "parameters, moments and gradients are not held twice)")
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
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="SST-2 TSV directory or npz of token ids; synthetic if unset")
    p.add_argument("--num_meta", type=int, default=200,
                   help="rows of the balanced meta set split off the real train set")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="save an engine checkpoint on validation improvement")
    return p.parse_args(argv)


if __name__ == "__main__":
    build_engine(parse_args()).run()
