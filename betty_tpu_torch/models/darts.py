"""DARTS: the search space (a supernet of architecture-weighted mixed ops),
the genotype, and the evaluation network of a discrete genotype.

Counterpart of ``betty_tpu/models/darts.py``. As there, the architecture
logits are an argument of the supernet's forward, not its parameters, so
the arch problem's alphas reach the classifier's loss as an ordinary
differentiable input (``self.module(x, self.arch.params)``). Inputs are
NHWC images as in the JAX package; the networks work on NCHW.

Search space: cells of ``NUM_NODES`` = 4 intermediate nodes over 14 edges,
each edge a ``MixedOp``, the softmax-weighted sum of the 8 ``PRIMITIVES``
("none" contributes zeros, so it is left out of the sum; its alpha still
gets the softmax's gradient). The search's BatchNorms have no scale or bias
(``affine=False``); pooling is followed by one. Reductions halve the
resolution at ``layers // 3`` and ``2 * layers // 3``; convolutions and
pools pad as flax's ``"SAME"`` (``models/layers.py``), and
``FactorizedReduce`` pads its shifted half at the end to the other's size.

Evaluation network (``DARTSEvalNetwork``): the cells of a ``Genotype``
(two edges a node, no BatchNorm after the pools), drop-path on every edge
but the identity skips, an auxiliary head at the cell ``2 * layers // 3``
in train mode. Drop-path draws from the ``"droppath"`` collection's seed
(``rngs``) through one generator a forward; ``drop_path_prob`` may be a 0-d
tensor (the per-epoch schedule) and a tensor always takes the draw, as a
traced scalar does in JAX.

Running statistics come back through ``updates`` (``models/batchnorm.py``).
Initialization draws flax's distributions from an explicit
``torch.Generator``; ``betty_tpu_torch.convert.from_flax_darts`` carries
the JAX package's variables over.
"""

import json
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from betty_tpu_torch.models.batchnorm import BatchNorm
from betty_tpu_torch.models.init import lecun_normal_
from betty_tpu_torch.models.layers import Conv, avg_pool, max_pool
from betty_tpu_torch.utils import seeded_generator

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)

NUM_NODES = 4  # intermediate nodes per cell
NUM_EDGES = sum(2 + i for i in range(NUM_NODES))  # 14


def num_alphas():
    return NUM_EDGES, len(PRIMITIVES)


class ReLUConvBN(nn.Module):
    def __init__(self, in_features, filters, kernel=1, stride=1, affine=True, device=None,
                 generator=None):
        super().__init__()
        self.conv = Conv(in_features, filters, kernel, stride, device, generator)
        self.bn = BatchNorm(filters, device=device, affine=affine)

    def forward(self, x, train=True, updates=None):
        return self.bn(self.conv(F.relu(x)), train, updates)


class SepConv(nn.Module):
    """Two (ReLU, depthwise k x k, pointwise 1x1, BatchNorm) units; the
    first carries the stride."""

    def __init__(self, in_features, filters, kernel, stride=1, affine=True, device=None,
                 generator=None):
        super().__init__()
        c = in_features
        self.dw0 = Conv(c, c, kernel, stride, device, generator, groups=c)
        self.pw0 = Conv(c, c, 1, 1, device, generator)
        self.bn0 = BatchNorm(c, device=device, affine=affine)
        self.dw1 = Conv(c, c, kernel, 1, device, generator, groups=c)
        self.pw1 = Conv(c, filters, 1, 1, device, generator)
        self.bn1 = BatchNorm(filters, device=device, affine=affine)

    def forward(self, x, train=True, updates=None):
        x = self.bn0(self.pw0(self.dw0(F.relu(x))), train, updates)
        return self.bn1(self.pw1(self.dw1(F.relu(x))), train, updates)


class DilConv(nn.Module):
    def __init__(self, in_features, filters, kernel, stride=1, dilation=2, affine=True,
                 device=None, generator=None):
        super().__init__()
        c = in_features
        self.dw = Conv(c, c, kernel, stride, device, generator, dilation=dilation, groups=c)
        self.pw = Conv(c, filters, 1, 1, device, generator)
        self.bn = BatchNorm(filters, device=device, affine=affine)

    def forward(self, x, train=True, updates=None):
        return self.bn(self.pw(self.dw(F.relu(x))), train, updates)


class FactorizedReduce(nn.Module):
    """Two stride-2 1x1 convolutions, the second on the input shifted by one
    row and column (padded at the end to the first's size), concatenated."""

    def __init__(self, in_features, filters, affine=True, device=None, generator=None):
        super().__init__()
        self.conv_a = Conv(in_features, filters // 2, 1, 2, device, generator)
        self.conv_b = Conv(in_features, filters // 2, 1, 2, device, generator)
        self.bn = BatchNorm(filters // 2 * 2, device=device, affine=affine)

    def forward(self, x, train=True, updates=None):
        x = F.relu(x)
        a = self.conv_a(x)
        b = self.conv_b(x[:, :, 1:, 1:])
        if b.shape[2:] != a.shape[2:]:
            b = F.pad(b, (0, a.shape[3] - b.shape[3], 0, a.shape[2] - b.shape[2]))
        return self.bn(torch.cat([a, b], dim=1), train, updates)


def _pool(x, kind, stride):
    return (max_pool if kind == "max" else avg_pool)(x, 3, stride)


class Pool(nn.Module):
    """A discrete cell's 3x3 SAME pool (no parameters, no BatchNorm)."""

    def __init__(self, kind, stride):
        super().__init__()
        self.kind, self.stride = kind, stride

    def forward(self, x, train=True, updates=None):
        return _pool(x, self.kind, self.stride)


class MixedOp(nn.Module):
    """One edge of the supernet: the ``weights``-weighted sum of every
    primitive's output (the reference builds every candidate op with
    ``affine=False``)."""

    def __init__(self, filters, stride, affine=False, device=None, generator=None):
        super().__init__()
        c, g = filters, generator
        self.stride = stride
        self.max_bn = BatchNorm(c, device=device, affine=affine)
        self.avg_bn = BatchNorm(c, device=device, affine=affine)
        self.skip = (FactorizedReduce(c, c, affine, device, g) if stride != 1 else None)
        self.sep_conv_3x3 = SepConv(c, c, 3, stride, affine, device, g)
        self.sep_conv_5x5 = SepConv(c, c, 5, stride, affine, device, g)
        self.dil_conv_3x3 = DilConv(c, c, 3, stride, 2, affine, device, g)
        self.dil_conv_5x5 = DilConv(c, c, 5, stride, 2, affine, device, g)

    def forward(self, x, weights, train=True, updates=None):
        s = self.stride
        outs = [self.max_bn(_pool(x, "max", s), train, updates),
                self.avg_bn(_pool(x, "avg", s), train, updates),
                x if self.skip is None else self.skip(x, train, updates),
                self.sep_conv_3x3(x, train, updates),
                self.sep_conv_5x5(x, train, updates),
                self.dil_conv_3x3(x, train, updates),
                self.dil_conv_5x5(x, train, updates)]
        # weights[0] is "none": its output is zeros
        stacked = torch.stack(outs)
        out = weights[1:] @ stacked.reshape(len(outs), -1)
        return out.reshape(outs[0].shape)


class Cell(nn.Module):
    def __init__(self, in_prev_prev, in_prev, filters, reduction, reduction_prev, device=None,
                 generator=None):
        super().__init__()
        c, g = filters, generator
        self.reduction = reduction
        if reduction_prev:
            self.pre0 = FactorizedReduce(in_prev_prev, c, False, device, g)
        else:
            self.pre0 = ReLUConvBN(in_prev_prev, c, affine=False, device=device, generator=g)
        self.pre1 = ReLUConvBN(in_prev, c, affine=False, device=device, generator=g)
        self.ops = nn.ModuleList(
            MixedOp(c, 2 if reduction and j < 2 else 1, device=device, generator=g)
            for i in range(NUM_NODES) for j in range(2 + i))

    def forward(self, s0, s1, weights, train=True, updates=None):
        """``weights``: (NUM_EDGES, P) softmaxed alphas of this cell type."""
        states = [self.pre0(s0, train, updates), self.pre1(s1, train, updates)]
        offset = 0
        for _ in range(NUM_NODES):
            acc = None
            for j, h in enumerate(states):
                o = self.ops[offset + j](h, weights[offset + j], train, updates)
                acc = o if acc is None else acc + o
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-NUM_NODES:], dim=1)


def _dense(in_features, out_features, device, generator):
    head = nn.Linear(in_features, out_features, device=device)
    lecun_normal_(head.weight, fan_in=in_features, generator=generator)
    nn.init.zeros_(head.bias)
    return head


def _stem(channels, device, generator):
    return Conv(3, 3 * channels, 3, 1, device, generator), BatchNorm(3 * channels, device=device)


def _is_reduction(i, layers):
    return i in (layers // 3, 2 * layers // 3)


class DARTSNetwork(nn.Module):
    """The searchable supernet. ``alphas`` is a dict with "normal" and
    "reduce" logits of shape (NUM_EDGES, len(PRIMITIVES)); the softmax
    happens inside, so the arch problem holds raw logits."""

    def __init__(self, channels: int = 16, layers: int = 8, num_classes: int = 10,
                 device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.stem, self.stem_bn = _stem(channels, device, gen)
        c_pp = c_p = 3 * channels
        c, reduction_prev, cells = channels, False, []
        for i in range(layers):
            reduction = _is_reduction(i, layers)
            if reduction:
                c *= 2
            cells.append(Cell(c_pp, c_p, c, reduction, reduction_prev, device, gen))
            c_pp, c_p = c_p, NUM_NODES * c
            reduction_prev = reduction
        self.cells = nn.ModuleList(cells)
        self.head = _dense(c_p, num_classes, device, gen)

    def forward(self, x, alphas, train: bool = True, rngs=None, updates=None):
        w_normal = torch.softmax(alphas["normal"], dim=-1)
        w_reduce = torch.softmax(alphas["reduce"], dim=-1)
        x = self.stem_bn(self.stem(x.permute(0, 3, 1, 2).contiguous()), train, updates)
        s0 = s1 = x
        for cell in self.cells:
            s0, s1 = s1, cell(s0, s1, w_reduce if cell.reduction else w_normal, train, updates)
        return self.head(s1.mean(dim=(2, 3)))


def init_alphas(generator: torch.Generator = None, scale: float = 1e-3, device=None):
    """Architecture logits (the arch problem's parameters), drawn from
    ``generator`` (a CPU generator seeded 0 by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    E, P = num_alphas()
    return {name: (scale * torch.randn(E, P, generator=generator)).to(device)
            for name in ("normal", "reduce")}


class Genotype(NamedTuple):
    normal: Tuple
    normal_concat: Sequence[int]
    reduce: Tuple
    reduce_concat: Sequence[int]


def genotype_to_json(genotype: Genotype) -> str:
    """The search -> evaluation handoff, in the JAX package's JSON layout
    (each package reads the other's files)."""
    return json.dumps({
        "normal": [list(e) for e in genotype.normal],
        "normal_concat": list(genotype.normal_concat),
        "reduce": [list(e) for e in genotype.reduce],
        "reduce_concat": list(genotype.reduce_concat),
    })


def genotype_from_json(text: str) -> Genotype:
    d = json.loads(text)
    return Genotype(
        normal=tuple((str(n), int(i)) for n, i in d["normal"]),
        normal_concat=tuple(d["normal_concat"]),
        reduce=tuple((str(n), int(i)) for n, i in d["reduce"]),
        reduce_concat=tuple(d["reduce_concat"]),
    )


# DARTS_V2 of the reference's published genotypes
# (examples/neural_architecture_search/genotypes.py): the evaluation phase's
# architecture when no search result is given
DARTS_V2 = Genotype(
    normal=(("sep_conv_3x3", 0), ("sep_conv_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)),
    normal_concat=(2, 3, 4, 5),
    reduce=(("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 1), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)),
    reduce_concat=(2, 3, 4, 5),
)


def derive_genotype(alphas) -> Genotype:
    """The discrete architecture: each node keeps its two incoming edges
    with the strongest non-"none" op, and that op (the reference's rule)."""

    def parse(logits):
        w = torch.softmax(torch.as_tensor(logits).detach().cpu(), dim=-1).numpy()
        gene = []
        offset = 0
        none_idx = PRIMITIVES.index("none")
        names = [p for p in PRIMITIVES if p != "none"]
        for i in range(NUM_NODES):
            n_in = 2 + i
            edges = w[offset:offset + n_in]
            strength = np.max(np.delete(edges, none_idx, axis=1), axis=1)
            top2 = np.argsort(-strength)[:2]
            for j in sorted(top2):
                ops = np.delete(edges[j], none_idx)
                gene.append((names[int(np.argmax(ops))], int(j)))
            offset += n_in
        return tuple(gene)

    concat = tuple(range(2, 2 + NUM_NODES))
    return Genotype(normal=parse(alphas["normal"]), normal_concat=concat,
                    reduce=parse(alphas["reduce"]), reduce_concat=concat)


# ---------------------------------------------------------------------------
# Evaluation phase: the network of a discrete genotype (reference
# ``model.py``: ``Cell``, ``AuxiliaryHeadCIFAR``, ``NetworkCIFAR``, and
# ``utils.drop_path``)
# ---------------------------------------------------------------------------


def drop_path(x, drop_prob, generator):
    """Per-sample stochastic depth: zero a sample's edge output with
    probability ``drop_prob`` (a number or a 0-d tensor) and scale the
    survivors by 1/keep; the mask is ``uniform < keep`` from ``generator``."""
    keep = 1.0 - drop_prob
    u = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device, dtype=x.dtype)
    mask = (u < keep).to(x.dtype)
    denom = torch.clamp(keep, min=1e-8) if torch.is_tensor(keep) else max(keep, 1e-8)
    return x * mask / denom


def _discrete_op(name, filters, stride, device, generator):
    """A discrete cell's op; ``nn.Identity`` for a stride-1 skip (exempt from
    drop-path). Pools carry no BatchNorm here (the reference adds it to the
    pools only inside the search's MixedOp)."""
    if name == "skip_connect":
        if stride == 1:
            return nn.Identity()
        return FactorizedReduce(filters, filters, True, device, generator)
    if name in ("max_pool_3x3", "avg_pool_3x3"):
        return Pool(name.split("_")[0], stride)
    kernel = 3 if name.endswith("3x3") else 5
    if name.startswith("sep_conv"):
        return SepConv(filters, filters, kernel, stride, True, device, generator)
    if name.startswith("dil_conv"):
        return DilConv(filters, filters, kernel, stride, 2, True, device, generator)
    raise ValueError(f"op {name!r} cannot appear in a discrete genotype")


class DiscreteCell(nn.Module):
    """One cell of the evaluation network: each intermediate node sums two
    genotype-selected edges."""

    def __init__(self, genotype: Genotype, in_prev_prev, in_prev, filters, reduction,
                 reduction_prev, device=None, generator=None):
        super().__init__()
        c, g = filters, generator
        if reduction_prev:
            self.pre0 = FactorizedReduce(in_prev_prev, c, True, device, g)
        else:
            self.pre0 = ReLUConvBN(in_prev_prev, c, device=device, generator=g)
        self.pre1 = ReLUConvBN(in_prev, c, device=device, generator=g)
        gene = genotype.reduce if reduction else genotype.normal
        self.concat = tuple(genotype.reduce_concat if reduction else genotype.normal_concat)
        self.indices = tuple(idx for _, idx in gene)
        self.ops = nn.ModuleList(
            _discrete_op(name, c, 2 if reduction and idx < 2 else 1, device, g)
            for name, idx in gene)

    def forward(self, s0, s1, drop_prob=0.0, train=True, updates=None, generator=None):
        # the draw is skipped only where the probability is a number 0
        use_dp = train and (torch.is_tensor(drop_prob) or drop_prob > 0.0)
        states = [self.pre0(s0, train, updates), self.pre1(s1, train, updates)]
        for i in range(len(self.ops) // 2):
            hs = []
            for k in (2 * i, 2 * i + 1):
                op, h = self.ops[k], states[self.indices[k]]
                if isinstance(op, nn.Identity):
                    hs.append(h)
                    continue
                h = op(h, train, updates)
                if use_dp:
                    if generator is None:
                        raise ValueError("drop-path needs the 'droppath' rng in train mode")
                    h = drop_path(h, drop_prob, generator)
                hs.append(h)
            states.append(hs[0] + hs[1])
        return torch.cat([states[i] for i in self.concat], dim=1)


class AuxiliaryHeadCIFAR(nn.Module):
    """On the 8x8 map of the 2/3-depth cell: ReLU, 5x5/3 VALID average pool
    to 2x2, 1x1 -> 128, BatchNorm, ReLU, 2x2 VALID -> 768, BatchNorm, ReLU,
    linear."""

    def __init__(self, in_features, num_classes, device=None, generator=None):
        super().__init__()
        g = generator
        self.conv1 = Conv(in_features, 128, 1, 1, device, g)
        self.bn1 = BatchNorm(128, device=device)
        self.conv2 = Conv(128, 768, 2, 1, device, g, padding="VALID")
        self.bn2 = BatchNorm(768, device=device)
        self.head = _dense(768, num_classes, device, g)

    def forward(self, x, train=True, updates=None):
        x = avg_pool(F.relu(x), 5, 3, padding="VALID")
        x = F.relu(self.bn1(self.conv1(x), train, updates))
        x = F.relu(self.bn2(self.conv2(x), train, updates))
        return self.head(x.permute(0, 2, 3, 1).flatten(1))


class DARTSEvalNetwork(nn.Module):
    """The evaluation network (reference ``NetworkCIFAR``): stem, the stack
    of discrete cells (channels double at 1/3 and 2/3 depth), global pool,
    classifier, and the auxiliary classifier at the 2/3 cell in train mode.
    Returns ``(logits, aux_logits or None)``."""

    def __init__(self, genotype: Genotype, channels: int = 36, layers: int = 20,
                 num_classes: int = 10, auxiliary: bool = True, device=None, seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device if device is not None else "cpu").manual_seed(seed)
        self.stem, self.stem_bn = _stem(channels, device, gen)
        self.aux_index = 2 * layers // 3 if auxiliary else None
        c_pp = c_p = 3 * channels
        c, reduction_prev, cells = channels, False, []
        aux_in = None
        for i in range(layers):
            reduction = _is_reduction(i, layers)
            if reduction:
                c *= 2
            cell = DiscreteCell(genotype, c_pp, c_p, c, reduction, reduction_prev, device, gen)
            cells.append(cell)
            c_pp, c_p = c_p, len(cell.concat) * c
            reduction_prev = reduction
            if i == self.aux_index:
                aux_in = c_p
        self.cells = nn.ModuleList(cells)
        self.aux = AuxiliaryHeadCIFAR(aux_in, num_classes, device, gen) if auxiliary else None
        self.head = _dense(c_p, num_classes, device, gen)

    def forward(self, x, drop_path_prob=0.0, train: bool = True, rngs=None, updates=None):
        generator = None
        if (train and rngs is not None and "droppath" in rngs
                and (torch.is_tensor(drop_path_prob) or drop_path_prob > 0.0)):
            generator = seeded_generator(rngs["droppath"], x.device)
        x = self.stem_bn(self.stem(x.permute(0, 3, 1, 2).contiguous()), train, updates)
        s0 = s1 = x
        aux_logits = None
        for i, cell in enumerate(self.cells):
            s0, s1 = s1, cell(s0, s1, drop_path_prob, train, updates, generator)
            if i == self.aux_index and train:
                aux_logits = self.aux(s1, train, updates)
        return self.head(s1.mean(dim=(2, 3))), aux_logits
