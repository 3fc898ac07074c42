"""Switch-style top-1 mixture-of-experts feed-forward layer
(``betty_tpu/models/moe.py``; Switch Transformers, arXiv:2101.03961).

Routing is expressed as the JAX package's dense one-hot dispatch and
combine einsums: differentiable (hypergradients reach the router), static
shapes, the expert weights carrying a leading ``E`` axis. Each expert takes
at most ``capacity`` tokens (``ceil(capacity_factor * T / E)``, computed on
the host from the static shapes, so a compiled block captures it); tokens
past it bypass the layer (their output is 0: add the residual outside).

The parameters are a dict with JAX's names and layouts: ``router`` (d, E),
``w1`` (E, d, h), ``b1`` (E, h), ``w2`` (E, h, d), ``b2`` (E, d);
``convert.from_jax_moe`` carries the JAX package's across.

Under ``Config(precision="bf16")`` the problem's forward hands the layer
bf16 tokens and parameters; the routing bookkeeping (the one-hot, each
token's position in its expert's buffer) stays float32 whatever the input
dtype, because a bf16 cumsum counts exactly only up to 256 and experts with
more routed tokens would otherwise share buffer positions. ``onehot``,
``keep`` and ``dispatch`` take the input's dtype, as in JAX.

Under expert parallelism (a mesh with a model axis bound: ``strategy="ep"``,
or ``"tp"`` with ``shard_rules`` naming ``ep``) the expert-stacked leaves
arrive as this rank's E/m experts. Routing runs on every token, which every
rank of the model group holds: the router, the softmax, top-1 and the
positions, and the aux loss from those replicated probabilities. The
dispatch and the expert products take this rank's experts only, and their
combine is summed over the model group (``parallel.reduce_from_model``;
each token has one expert, so the sum adds zeros to one product). The
tokens enter the split computation through *f*
(``parallel.copy_to_model``), whose backward sums the ranks' cotangents.
An expert leaf that arrives whole on several ranks (a layout that does not
shard it) keeps the one-rank path.

On several model axes (``parallel.mesh.moe_axes``) the experts go over ``ep``
(else ``mdl``) and, beside ``ep``, each expert's hidden columns over
``mdl``: a rank holds E/ep experts and h/mdl of their columns (``w1`` [E/ep,
d, h/mdl], ``b1`` [E/ep, h/mdl], ``w2`` [E/ep, h/mdl, d], ``b2`` [E/ep, d];
``MOE_COMPOSED_SHARD_RULES``), as Megatron's MLP inside expert
parallelism. The tokens enter through *f* over both axes (their pair's group,
``Mesh.over``: a third axis repeats the layer and stays out of it), the expert
products run on the local block, the second product's partial sums are
reduced over ``mdl`` (*g*) before ``b2`` is added (once, as the
transformer's ``fc2`` bias), and the combine is reduced over ``ep``.
``Problem.forward`` hands the leaves over cut so
(``parallel.mesh.moe_local_dim``); a ``pp`` or ``sp`` axis beside them
repeats the layer. Routing stays whole on every rank, as on one.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from betty_tpu_torch.parallel import copy_to_model, reduce_from_model
from betty_tpu_torch.parallel.mesh import MOE_COMPOSED_SHARD_RULES  # noqa: F401
from betty_tpu_torch.parallel.mesh import current, moe_axes


def init_moe_params(generator: Optional[torch.Generator], dim: int, hidden: int,
                    num_experts: int, device=None, dtype=torch.float32):
    """Router and per-expert FFN weights (normal draws scaled by
    ``1/sqrt(fan_in)``, zero biases), drawn on ``generator``'s device and
    moved to ``device``."""
    gen_device = generator.device if generator is not None else "cpu"

    def normal(*shape, scale):
        x = torch.randn(shape, generator=generator, device=gen_device, dtype=torch.float32)
        return (scale * x).to(device=device, dtype=dtype)

    s1, s2 = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hidden)
    return {
        "router": normal(dim, num_experts, scale=s1),
        "w1": normal(num_experts, dim, hidden, scale=s1),
        "b1": torch.zeros(num_experts, hidden, device=device, dtype=dtype),
        "w2": normal(num_experts, hidden, dim, scale=s2),
        "b2": torch.zeros(num_experts, dim, device=device, dtype=dtype),
    }


def expert_capacity(tokens: int, num_experts: int, capacity_factor: float = 1.25,
                    capacity: Optional[int] = None) -> int:
    """Buffer slots per expert: ``capacity`` if given, else
    ``max(1, ceil(capacity_factor * tokens / num_experts))``."""
    if capacity is not None:
        return int(capacity)
    return max(1, int(math.ceil(capacity_factor * tokens / num_experts)))


def router_probs(router, x):
    """``softmax(x @ router)`` [T, E] in ``x``'s dtype, rounded as JAX
    rounds it: the product accumulated in at least float32 and rounded once
    (XLA's bf16 dot), then ``jax.nn.softmax``'s steps (subtract the row
    max, exp, sum, divide), each rounded to the dtype. ``torch.softmax``
    rounds a bf16 result once, which moves some probabilities by an ulp and
    the top-1 choice of near-ties with them."""
    acc = torch.promote_types(x.dtype, torch.float32)
    logits = (x.to(acc) @ router.to(acc)).to(x.dtype)
    unnormalized = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    return unnormalized / unnormalized.sum(dim=-1, keepdim=True)


def route(probs, capacity: int, dtype):
    """Top-1 routing of router probabilities ``probs`` [T, E]: ``(gate [T],
    onehot [T, E], dispatch [T, E, C])``. ``argmax`` takes the first of tied
    experts, as JAX's does. Positions are counted in float32; ``onehot`` and
    ``dispatch`` are in ``dtype``."""
    E = probs.shape[1]
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    onehot32 = F.one_hot(expert_idx, E).to(torch.float32)
    # position of each token within its expert's buffer (0-based)
    pos = torch.cumsum(onehot32, dim=0) * onehot32 - onehot32
    keep = ((pos < capacity) & (onehot32 > 0)).to(dtype)
    pos_clipped = torch.clamp(pos, max=capacity - 1).to(torch.int64)
    dispatch = keep[:, :, None] * F.one_hot(pos_clipped, capacity).to(dtype)
    return gate, onehot32.to(dtype), dispatch


def moe_ffn(params, x, capacity_factor: float = 1.25, capacity: Optional[int] = None):
    """Switch top-1 MoE FFN over flattened tokens ``x`` [T, d]. Returns
    ``(y, aux)``: ``y`` [T, d] the gated expert outputs (0 for the tokens
    past an expert's capacity) and ``aux`` the Switch load-balancing loss
    (``E`` times the sum over experts of the fraction routed times the mean
    router probability)."""
    T = x.shape[0]
    E = params["router"].shape[1]
    C = expert_capacity(T, E, capacity_factor, capacity)

    probs = router_probs(params["router"], x)                        # [T, E]
    gate, onehot, dispatch = route(probs, C, x.dtype)

    experts = {k: params[k] for k in ("w1", "b1", "w2", "b2")}
    mesh, hidden = _split_meshes(current(), E, experts["w1"])
    if mesh is not None:
        experts, x_in, dispatch_in = _local_experts(experts, x, dispatch, E, mesh, hidden)
    else:
        x_in, dispatch_in = x, dispatch
    expert_in = torch.einsum("tec,td->ecd", dispatch_in, x_in)       # [E, C, d]
    h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, experts["w1"])
               + experts["b1"][:, None, :], approximate="tanh")
    expert_out = torch.einsum("ech,ehd->ecd", h, experts["w2"])
    if hidden is not None:
        # row parallel over the hidden columns: the sum first, b2 once
        expert_out = reduce_from_model(expert_out, hidden)
    expert_out = expert_out + experts["b2"][:, None, :]              # [E, C, d]
    combined = torch.einsum("tec,ecd->td", dispatch_in, expert_out)
    if mesh is not None:
        combined = reduce_from_model(combined, mesh)
    y = combined * gate[:, None]

    fraction = onehot.mean(dim=0)                                    # [E]
    mean_prob = probs.mean(dim=0)                                    # [E]
    aux = E * torch.sum(fraction * mean_prob)
    return y, aux


def _split_meshes(bound, E, w1):
    """``(expert mesh, hidden mesh)``: the views of the bound mesh the layer
    splits its experts and (beside ``ep``) their hidden columns over, None
    for an axis it does not split; both None where the experts arrive whole
    on several ranks (the one-rank path)."""
    expert, hidden = moe_axes(bound)
    if expert is None:
        return None, None
    mesh = bound.view(expert)
    if mesh.model_size > 1 and w1.shape[0] == E:
        return None, None
    return mesh, None if hidden is None else bound.view(hidden)


def _local_experts(experts, x, dispatch, E, mesh, hidden=None):
    """``(this rank's expert leaves, x through f, this rank's dispatch
    columns)``: the leaves arrive as their E/m chunk or whole (then through
    f and cut); beside a ``hidden`` view, cut on their hidden columns too,
    and ``x`` through f over both axes (the pair's group, not the whole
    model group: a ``pp`` or ``sp`` axis beside them repeats the layer). The dispatch is built from
    comparisons and carries no gradient."""
    m, i = mesh.model_size, mesh.model_index
    if E % m:
        raise ValueError(f"expert parallelism: {E} experts do not divide over {m} ranks")
    local = {}
    for k, w in experts.items():
        if w.shape[0] * m != E:
            w = copy_to_model(w, mesh).chunk(m, 0)[i]
        local[k] = w
    n = E // m
    group = mesh if hidden is None else current().over((mesh.model_axis, hidden.model_axis))
    return local, copy_to_model(x, group), dispatch[:, i * n:(i + 1) * n]


def moe_ffn_dense(params, x):
    """Every token to its top-1 expert, none dropped (capacity ``T``)."""
    return moe_ffn(params, x, capacity=x.shape[0])
