"""Move parameters from the JAX package to the port.

``from_flax_transformer``, ``from_flax_mlp`` and ``from_flax_mwn`` take a
flax parameter tree as a nested dict of numpy arrays
(``engine.states[name]["params"]`` of the JAX package, after
``np.asarray``) and return the params dict of the port's
``TransformerClassifier`` / ``MLP`` / ``MetaWeightNet``. flax ``Dense``
kernels are ``(in, out)`` and ``nn.Linear`` weights ``(out, in)``, so they are
transposed; the attention kernels keep their shapes; LayerNorm ``scale``
becomes ``weight``. ``from_flax_resnet`` takes a ``ResNet``'s variables
(``params`` and ``batch_stats``) and returns the port's params and
batch_stats dicts: conv kernels ``(kh, kw, in, out)`` become ``(out, in,
kh, kw)``, BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``. ``from_flax_net``
(also named ``from_flax_darts``) does the same for the DARTS supernet and
evaluation network, ``ResNetV1`` and ``WideResNet``, mapping flax's
auto-names onto the port's module names, and ``from_flax_alphas``
carries the architecture logits. ``from_flax_captioner`` maps IUC's
``Captioner`` (and JAX's frozen projection, when given) and
``from_flax_omniglot`` the Omniglot CNN's variables. ``from_jax_moe`` takes
the JAX package's MoE parameter dict (``models/moe.py``), whose layouts the
port keeps. ``from_jax_pipelined`` takes ``make_pipelined_transformer``'s
``{"embed", "blocks", "head"}`` tree (the blocks a vmapped flax
``EncoderBlock``'s, a leading depth axis on every leaf) and keeps the depth
axis.
"""

import numpy as np
import torch
from torch import nn


def _t(x, device, dtype):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _dense(out, prefix, p, device, dtype):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T, device, dtype)
    out[f"{prefix}.bias"] = _t(p["bias"], device, dtype)


def _layernorm(out, prefix, p, device, dtype):
    out[f"{prefix}.weight"] = _t(p["scale"], device, dtype)
    out[f"{prefix}.bias"] = _t(p["bias"], device, dtype)


def from_flax_transformer(params, device="cpu", dtype=torch.float32):
    """flax ``TransformerClassifier`` params -> the port's params dict (with
    ``remat=True`` flax names the blocks ``CheckpointEncoderBlock_i``)."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"], device, dtype),
           "pos_embedding": _t(params["pos_embedding"], device, dtype)}
    block = "CheckpointEncoderBlock_" if "CheckpointEncoderBlock_0" in params else "EncoderBlock_"
    depth = sum(1 for k in params if k.startswith(block))
    for i in range(depth):
        blk = params[f"{block}{i}"]
        pre = f"blocks.{i}"
        _layernorm(out, f"{pre}.ln1", blk["LayerNorm_0"], device, dtype)
        attn = blk["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value", "out"):
            out[f"{pre}.attn.{name}.kernel"] = _t(attn[name]["kernel"], device, dtype)
            out[f"{pre}.attn.{name}.bias"] = _t(attn[name]["bias"], device, dtype)
        _dense(out, f"{pre}.fc1", blk["Dense_0"], device, dtype)
        _dense(out, f"{pre}.fc2", blk["Dense_1"], device, dtype)
        _layernorm(out, f"{pre}.ln2", blk["LayerNorm_1"], device, dtype)
    _layernorm(out, "ln_f", params["LayerNorm_0"], device, dtype)
    _dense(out, "pool", params["Dense_0"], device, dtype)
    _dense(out, "head", params["Dense_1"], device, dtype)
    return out


def from_flax_mlp(params, device="cpu", dtype=torch.float32):
    """flax ``MLP`` params (``Dense_0``, ``Dense_1``, ...) -> the port's
    ``MLP`` params dict (``layers.i.weight/bias``)."""
    out = {}
    for i in range(sum(1 for k in params if k.startswith("Dense_"))):
        _dense(out, f"layers.{i}", params[f"Dense_{i}"], device, dtype)
    return out


def from_flax_mwn(params, device="cpu", dtype=torch.float32):
    """flax ``MetaWeightNet`` params -> the port's params dict."""
    out = {}
    _dense(out, "dense0", params["Dense_0"], device, dtype)
    _dense(out, "dense1", params["Dense_1"], device, dtype)
    return out


def _conv(out, prefix, p, device, dtype):
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), device,
                                 dtype)


def _batchnorm(params, stats, prefix, p, s, device, dtype):
    params[f"{prefix}.weight"] = _t(p["scale"], device, dtype)
    params[f"{prefix}.bias"] = _t(p["bias"], device, dtype)
    stats[f"{prefix}.running_mean"] = _t(s["mean"], device, dtype)
    stats[f"{prefix}.running_var"] = _t(s["var"], device, dtype)


def from_flax_resnet(variables, device="cpu", dtype=torch.float32):
    """flax ``ResNet`` variables -> the port's ``(params, batch_stats)``.

    The flax tree is ``Conv_0, BatchNorm_0, BasicBlock_0.., Dense_0``; a
    block is ``Conv_0, BatchNorm_0, Conv_1, BatchNorm_1`` and, where it
    projects its residual, ``Conv_2, BatchNorm_2``."""
    p, s = variables["params"], variables["batch_stats"]
    params, stats = {}, {}
    _conv(params, "conv", p["Conv_0"], device, dtype)
    _batchnorm(params, stats, "bn", p["BatchNorm_0"], s["BatchNorm_0"], device, dtype)
    depth = sum(1 for k in p if k.startswith("BasicBlock_"))
    names = (("Conv_0", "BatchNorm_0", "conv0", "bn0"), ("Conv_1", "BatchNorm_1", "conv1", "bn1"),
             ("Conv_2", "BatchNorm_2", "proj", "proj_bn"))
    for i in range(depth):
        bp, bs = p[f"BasicBlock_{i}"], s[f"BasicBlock_{i}"]
        for conv, norm, conv_name, norm_name in names:
            if conv in bp:
                _conv(params, f"blocks.{i}.{conv_name}", bp[conv], device, dtype)
                _batchnorm(params, stats, f"blocks.{i}.{norm_name}", bp[norm], bs[norm], device,
                           dtype)
    _dense(params, "head", p["Dense_0"], device, dtype)
    return params, stats


def _flax_name(module):
    """flax's class name of a port module: ``Dense`` for a linear layer, the
    module's own class name where it holds parameters or buffers, and None
    where it holds neither (a pool, an identity skip: flax has no module
    there)."""
    if isinstance(module, nn.Linear):
        return "Dense"
    if next(module.parameters(), None) is None and next(module.buffers(), None) is None:
        return None
    return type(module).__name__


def _flax_children(module, prefix):
    """``(port prefix, child)`` in registration order, through lists."""
    for name, child in module.named_children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            yield from _flax_children(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", child


def _from_flax_tree(module, prefix, p, s, params, stats, device, dtype):
    """Fill ``params``/``stats`` for ``module``'s children from the flax
    subtrees ``p`` (params) and ``s`` (batch_stats). flax names a compact
    module's submodules ``<Class>_<i>`` in the order it creates them, which
    the port's modules register theirs in."""
    counts = {}
    for path, child in _flax_children(module, prefix):
        kind = _flax_name(child)
        if kind is None:
            continue
        name = f"{kind}_{counts.get(kind, 0)}"
        counts[kind] = counts.get(kind, 0) + 1
        cp, cs = p.get(name, {}), s.get(name, {})
        if kind == "Conv":
            _conv(params, path, cp, device, dtype)
        elif kind == "Dense":
            _dense(params, path, cp, device, dtype)
        elif kind == "BatchNorm":
            if child.weight is not None:
                params[f"{path}.weight"] = _t(cp["scale"], device, dtype)
                params[f"{path}.bias"] = _t(cp["bias"], device, dtype)
            stats[f"{path}.running_mean"] = _t(cs["mean"], device, dtype)
            stats[f"{path}.running_var"] = _t(cs["var"], device, dtype)
        else:
            _from_flax_tree(child, f"{path}.", cp, cs, params, stats, device, dtype)


def from_flax_net(variables, net, device="cpu", dtype=torch.float32):
    """flax variables -> the port's ``(params, batch_stats)`` for ``net``, the
    port's network of the same configuration, whose modules register in the
    order flax creates its submodules: the DARTS supernet and evaluation
    network (``Cell_2/MixedOp_5/SepConv_1/Conv_3`` ->
    ``cells.2.ops.5.sep_conv_5x5.pw1``), ``ResNetV1``
    (``BottleneckBlock_3/Conv_3`` -> ``blocks.3.proj``) and ``WideResNet``
    (whose only BatchNorm outside the blocks follows them). HWIO kernels,
    depthwise ``(k, k, 1, C)`` included, become OIHW; BatchNorms without
    scale and bias have running statistics only."""
    params, stats = {}, {}
    _from_flax_tree(net, "", variables["params"], variables.get("batch_stats", {}), params,
                    stats, device, dtype)
    return params, stats


from_flax_darts = from_flax_net  # the name of its first callers


def from_flax_alphas(alphas, device="cpu", dtype=torch.float32):
    """The JAX arch problem's ``{"normal", "reduce"}`` logits as tensors."""
    return {k: _t(alphas[k], device, dtype) for k in ("normal", "reduce")}


def _attention(out, prefix, p, device, dtype):
    for name in ("query", "key", "value", "out"):
        out[f"{prefix}.{name}.kernel"] = _t(p[name]["kernel"], device, dtype)
        out[f"{prefix}.{name}.bias"] = _t(p[name]["bias"], device, dtype)


def from_flax_captioner(params, proj=None, device="cpu", dtype=torch.float32):
    """flax IUC ``Captioner`` params -> ``(the port's params dict, proj)``:
    ``proj`` is JAX's frozen projection as a tensor when it is given (for
    the port's ``Captioner.proj`` buffer), else None. flax names the
    decoder blocks ``blocks_i`` with ``LayerNorm_0..2``,
    ``SelfAttention_0``, ``MultiHeadDotProductAttention_0`` (the
    cross-attention) and ``Dense_0/1``."""
    out = {}
    for i in range(2):
        _dense(out, f"enc_deep.{i}", params[f"enc_deep_{i}"], device, dtype)
    _layernorm(out, "enc_norm_a", params["enc_norm_a"], device, dtype)
    _layernorm(out, "enc_norm_b", params["enc_norm_b"], device, dtype)
    out["tok_emb.weight"] = _t(params["tok_emb"]["embedding"], device, dtype)
    out["pos_emb"] = _t(params["pos_emb"], device, dtype)
    for i in range(sum(1 for k in params if k.startswith("blocks_"))):
        blk, pre = params[f"blocks_{i}"], f"blocks.{i}"
        for j, ln in enumerate(("ln1", "ln2", "ln3")):
            _layernorm(out, f"{pre}.{ln}", blk[f"LayerNorm_{j}"], device, dtype)
        _attention(out, f"{pre}.self_attn", blk["SelfAttention_0"], device, dtype)
        _attention(out, f"{pre}.cross_attn", blk["MultiHeadDotProductAttention_0"], device,
                   dtype)
        _dense(out, f"{pre}.fc1", blk["Dense_0"], device, dtype)
        _dense(out, f"{pre}.fc2", blk["Dense_1"], device, dtype)
    _layernorm(out, "out_ln", params["out_ln"], device, dtype)
    _dense(out, "out_proj", params["out_proj"], device, dtype)
    return out, (None if proj is None else _t(proj, device, dtype))


def from_flax_omniglot(variables, device="cpu", dtype=torch.float32):
    """flax ``OmniglotCNN`` variables -> the port's ``(params,
    batch_stats)``: ``Conv_i`` (HWIO kernel and bias) -> ``convs.i``,
    ``BatchNorm_i`` -> ``norms.i``, ``Dense_0`` -> ``head``."""
    p, s = variables["params"], variables["batch_stats"]
    params, stats = {}, {}
    for i in range(sum(1 for k in p if k.startswith("Conv_"))):
        _conv(params, f"convs.{i}", p[f"Conv_{i}"], device, dtype)
        params[f"convs.{i}.bias"] = _t(p[f"Conv_{i}"]["bias"], device, dtype)
        _batchnorm(params, stats, f"norms.{i}", p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"],
                   device, dtype)
    _dense(params, "head", p["Dense_0"], device, dtype)
    return params, stats


def from_jax_moe(params, device="cpu", dtype=torch.float32):
    """``betty_tpu.models.moe.init_moe_params``'s dict (numpy arrays) -> the
    port's ``models/moe.py`` params: the same names and layouts (``router``
    (d, E), ``w1`` (E, d, h), ``b1`` (E, h), ``w2`` (E, h, d), ``b2`` (E, d))."""
    return {k: _t(params[k], device, dtype) for k in ("router", "w1", "b1", "w2", "b2")}


def from_jax_pipelined(params, device="cpu", dtype=torch.float32):
    """The JAX package's ``make_pipelined_transformer`` params -> the port's
    (``models.make_pipelined_transformer``): ``embed.tok``/``embed.pos``,
    the stacked ``blocks.*`` (flax ``Dense`` kernels ``(depth, in, out)``
    transposed to ``(depth, out, in)``, the attention kernels as they are,
    LayerNorm ``scale`` as ``weight``) and ``head.*``."""
    blocks = params["blocks"]
    out = {"embed.tok": _t(params["embed"]["tok"], device, dtype),
           "embed.pos": _t(params["embed"]["pos"], device, dtype)}
    for flax_name, name in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
        out[f"blocks.{name}.weight"] = _t(blocks[flax_name]["scale"], device, dtype)
        out[f"blocks.{name}.bias"] = _t(blocks[flax_name]["bias"], device, dtype)
    attn = blocks["MultiHeadDotProductAttention_0"]
    for name in ("query", "key", "value", "out"):
        out[f"blocks.attn.{name}.kernel"] = _t(attn[name]["kernel"], device, dtype)
        out[f"blocks.attn.{name}.bias"] = _t(attn[name]["bias"], device, dtype)
    for flax_name, name in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
        out[f"blocks.{name}.weight"] = _t(np.swapaxes(np.asarray(blocks[flax_name]["kernel"]),
                                                      1, 2), device, dtype)
        out[f"blocks.{name}.bias"] = _t(blocks[flax_name]["bias"], device, dtype)
    for k, v in params["head"].items():
        out[f"head.{k}"] = _t(v, device, dtype)
    return out
