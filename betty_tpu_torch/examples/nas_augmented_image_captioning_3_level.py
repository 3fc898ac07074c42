"""3-level NAS-augmented image captioning (IUC).

Port of ``examples/nas_augmented_image_captioning_3_level/main.py``: three
problems, ``outer`` (the architecture: two mixing logits of the encoder's
branches) over ``inner2`` (a learner captioner fit to pseudo-captions)
over ``inner1`` (the captioner), with the graph
``u2l={outer: [inner2, inner1]}``, ``l2u={inner1: [inner2, outer], inner2:
[outer]}`` and a first-order outer problem: three hypergradient paths into
``outer``.

* ``inner1`` trains the captioner (``models/iuc.py::Captioner``) by teacher
  forcing (``caption[:, :-1]`` in, ``caption[:, 1:]`` as targets, a
  pad-masked token cross entropy) plus ``--distill`` times a distillation
  term from the learner's predictions: an unmasked mean over every
  position, pad included, as JAX's.
* ``inner2``'s step greedy-decodes pseudo-captions of its (unlabeled)
  images with ``inner1``'s current parameters, read through the bound
  context (``self.inner1``), then fits the learner to them.
  ``greedy_decode`` is ``seq_len - 1`` forwards under ``torch.no_grad()``,
  each writing ``argmax(logits[:, t - 1])`` into column ``t`` of a device
  tensor: no host sync, so a compiled block captures it. The pseudo
  captions have length ``seq_len`` while teacher forcing feeds
  ``seq_len - 1`` tokens, as in JAX.
* ``outer`` takes ``inner1``'s caption loss on validation pairs.

Validation greedy-decodes the held-out fifth of the validation split with
the engine's states and reports the masked token accuracy and the
exact-match rate (percent).

The defaults are the JAX example's (n 512, batch 32, seq_len 12, vocab 64,
feat_dim 32, d 64, depth 2, 4 heads, unroll 2 and 2, SGD 0.1 / 0.05 with
momentum 0.9, Adam 1e-3 with betas (0.5, 0.999) on the alphas), on
synthetic scenes: an image is the sum of fixed random object embeddings
plus noise, its caption the sorted object tokens between BOS and EOS.
``--data-dir`` reads a pre-tokenized npz (``feats (N, F)``, ``captions
(N, L)``, BOS 1, EOS 2, PAD 0), split in thirds. Captions are int64.

    python -m betty_tpu_torch.examples.nas_augmented_image_captioning_3_level
    python -m betty_tpu_torch.examples.nas_augmented_image_captioning_3_level --device cpu \\
        --n 64 --batch 8 --seq_len 6 --dim 16 --depth 1 --heads 2 --train_iters 8

``--compile_blocks`` runs the steady schedule as compiled blocks.
"""

import argparse

import numpy as np
import torch

from betty_tpu_torch import Config, Engine, EngineConfig, ImplicitProblem, optim, parallel
from betty_tpu_torch.models.iuc import Captioner
from betty_tpu_torch.module import from_fn, from_torch
from betty_tpu_torch.utils import require_device

PAD, BOS, EOS = 0, 1, 2


def make_caption_data(n, seq_len, vocab, feat_dim, seed, noise=0.1):
    """Synthetic scenes: ``(feats (n, feat_dim) float32, captions (n,
    seq_len) int64)``."""
    rng = np.random.RandomState(seed)
    obj_emb = np.random.RandomState(1234).randn(vocab, feat_dim)
    feats = np.zeros((n, feat_dim), np.float32)
    caps = np.full((n, seq_len), PAD, np.int64)
    caps[:, 0] = BOS
    max_objs = seq_len - 2
    for i in range(n):
        k = rng.randint(2, max_objs + 1)
        objs = rng.choice(np.arange(3, vocab), size=k, replace=False)
        feats[i] = obj_emb[objs].sum(0) + noise * rng.randn(feat_dim)
        caps[i, 1:1 + k] = np.sort(objs)  # canonical order
        caps[i, 1 + k] = EOS
    return feats, caps


def caption_loss(logits, targets):
    """Token cross entropy masked at PAD, divided by ``max(sum(mask), 1)``;
    under a data-parallel mesh the mask's sum is the global batch's
    (``parallel.global_divisor``), so the ranks' mean loss is the global
    batch's."""
    mask = (targets != PAD).to(logits.dtype)
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
    return torch.sum(ce * mask) / parallel.global_divisor(torch.sum(mask), least=1.0)


@torch.no_grad()
def greedy_decode(apply_fn, feats, alphas, seq_len):
    """Argmax decoding: ``apply_fn(feats, alphas, caps)`` gives the logits;
    ``seq_len - 1`` forwards, each writing column ``t`` on the device."""
    caps = torch.full((feats.shape[0], seq_len), PAD, dtype=torch.int64, device=feats.device)
    caps[:, 0] = BOS
    for t in range(1, seq_len):
        caps[:, t] = apply_fn(feats, alphas, caps)[:, t - 1].argmax(dim=-1)
    return caps


class Outer(ImplicitProblem):
    """Architecture alphas; loss: inner1's caption loss on validation pairs."""

    def training_step(self, batch):
        feats, caps = batch
        logits = self.inner1(feats, self.params["w"], caps[:, :-1])
        return caption_loss(logits, caps[:, 1:])


class Inner2(ImplicitProblem):
    """Pseudo-data learner: fits inner1's greedy-decoded captions of its
    images, under the same alphas."""

    def training_step(self, batch):
        feats, _ = batch  # unlabeled: the captions are not used
        alphas = self.outer.params["w"]
        pseudo = greedy_decode(self.inner1, feats, alphas, self.cfg["seq_len"])
        logits = self.module(feats, alphas, pseudo[:, :-1])
        return caption_loss(logits, pseudo[:, 1:])


class Inner1(ImplicitProblem):
    """The captioner: teacher-forced cross entropy plus distillation from
    the learner's predictions."""

    def training_step(self, batch):
        feats, caps = batch
        alphas = self.outer.params["w"]
        logits = self.module(feats, alphas, caps[:, :-1])
        real = caption_loss(logits, caps[:, 1:])
        learner_logits = self.inner2(feats, alphas, caps[:, :-1])
        distill = -torch.mean(torch.sum(torch.softmax(learner_logits, dim=-1)
                                        * torch.log_softmax(logits, dim=-1), dim=-1))
        return real + self.cfg["distill"] * distill


class IUCEngine(Engine):
    """Greedy-decodes the held-out images at each validation: masked token
    accuracy and exact match, in percent."""

    test_data = None

    def validation(self):
        if self.test_data is None:
            return {}
        feats, caps = self.test_data
        alphas = self.states["outer"]["params"]["w"]
        dtype = alphas.dtype
        decoded = greedy_decode(self.inner1, torch.as_tensor(feats, device=self.device,
                                                             dtype=dtype),
                                alphas, caps.shape[1]).cpu().numpy()
        mask = caps != PAD
        mask[:, 0] = False  # BOS is given
        tok_acc = float((decoded == caps)[mask].mean()) * 100.0
        exact = float(((decoded == caps) | ~mask).all(axis=1).mean()) * 100.0
        return {"caption_acc": tok_acc, "caption_exact": exact}


def load_captions(path):
    """A pre-tokenized npz: ``(feats float32, captions int64)``."""
    d = np.load(path)
    return np.asarray(d["feats"], np.float32), np.asarray(d["captions"], np.int64)


def build_engine(args):
    device = require_device(args.device, "nas_augmented_image_captioning_3_level")
    feat_dim = args.feat_dim
    if getattr(args, "data_dir", None):
        feats, caps = load_captions(args.data_dir)
        args.seq_len = caps.shape[1]
        args.vocab = int(caps.max()) + 1
        feat_dim = feats.shape[1]
        third = len(caps) // 3
        f_tr, c_tr = feats[:third], caps[:third]
        f_ext, c_ext = feats[third:2 * third], caps[third:2 * third]
        f_val, c_val = feats[2 * third:], caps[2 * third:]
    else:
        f_tr, c_tr = make_caption_data(args.n, args.seq_len, args.vocab, feat_dim, 0)
        f_ext, c_ext = make_caption_data(args.n, args.seq_len, args.vocab, feat_dim, 1)
        f_val, c_val = make_caption_data(args.n, args.seq_len, args.vocab, feat_dim, 2)

    holdout = max(len(c_val) // 5, 1)
    f_test, c_test = f_val[-holdout:], c_val[-holdout:]
    f_val, c_val = f_val[:-holdout], c_val[:-holdout]

    def loader(f, c):
        return [(f[i:i + args.batch], c[i:i + args.batch])
                for i in range(0, len(c) - args.batch + 1, args.batch)]

    def captioner(seed):
        return from_torch(Captioner(vocab=args.vocab, feat_dim=feat_dim, dim=args.dim,
                                    depth=args.depth, heads=args.heads, max_len=args.seq_len,
                                    device=device, seed=seed))

    outer = Outer(
        name="outer",
        module=from_fn(lambda p: p["w"], {"w": torch.zeros(2)}),
        optimizer=optim.adam(lr=args.arch_lr, betas=(0.5, 0.999)),
        train_data_loader=loader(f_val, c_val),
        config=Config(type="darts", first_order=True, log_step=args.log_step),
    )
    inner2 = Inner2(
        name="inner2",
        module=captioner(1),
        optimizer=optim.sgd(lr=args.learner_lr, momentum=0.9),
        train_data_loader=loader(f_ext, c_ext),
        config=Config(type="darts", unroll_steps=args.unroll2),
        extra_config={"seq_len": args.seq_len},
    )
    inner1 = Inner1(
        name="inner1",
        module=captioner(0),
        optimizer=optim.sgd(lr=args.captioner_lr, momentum=0.9),
        train_data_loader=loader(f_tr, c_tr),
        config=Config(type="darts", unroll_steps=args.unroll1),
        extra_config={"distill": args.distill},
    )
    engine = IUCEngine(
        config=EngineConfig(train_iters=args.train_iters, valid_step=args.valid_step,
                            compile_blocks=args.compile_blocks),
        problems=[outer, inner2, inner1],
        dependencies={"u2l": {outer: [inner2, inner1]},
                      "l2u": {inner1: [inner2, outer], inner2: [outer]}},
        device=device,
    )
    engine.test_data = (f_test, c_test)
    return engine


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq_len", type=int, default=12)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--feat_dim", type=int, default=32)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--unroll1", type=int, default=2)
    p.add_argument("--unroll2", type=int, default=2)
    p.add_argument("--captioner_lr", type=float, default=0.1)
    p.add_argument("--arch_lr", type=float, default=1e-3,
                   help="outer (architecture) Adam learning rate")
    p.add_argument("--learner_lr", type=float, default=0.05)
    p.add_argument("--distill", type=float, default=0.1)
    p.add_argument("--train_iters", type=int, default=100)
    p.add_argument("--log_step", type=int, default=-1)
    p.add_argument("--valid_step", type=int, default=50)
    p.add_argument("--data-dir", dest="data_dir", type=str, default=None,
                   help="npz with feats (N,F) + captions (N,L) (BOS=1/EOS=2/PAD=0); "
                        "synthetic scenes if unset")
    p.add_argument("--compile_blocks", action="store_true",
                   help="compiled blocks: one CUDA graph replay a meta-period")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    engine = build_engine(parse_args(argv))
    engine.run()
    print(engine.validation())
    return engine


if __name__ == "__main__":
    main()
