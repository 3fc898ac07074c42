"""Move parameters from the JAX package to the port.

``from_flax_transformer`` and ``from_flax_mwn`` take a flax parameter tree
as a nested dict of numpy arrays (``engine.states[name]["params"]`` of the
JAX package, after ``np.asarray``) and return the params dict of the port's
``TransformerClassifier`` / ``MetaWeightNet``. flax ``Dense`` kernels are
``(in, out)`` and ``nn.Linear`` weights ``(out, in)``, so they are
transposed; the attention kernels keep their shapes; LayerNorm ``scale``
becomes ``weight``.
"""

import numpy as np
import torch


def _t(x, device, dtype):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _dense(out, prefix, p, device, dtype):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T, device, dtype)
    out[f"{prefix}.bias"] = _t(p["bias"], device, dtype)


def _layernorm(out, prefix, p, device, dtype):
    out[f"{prefix}.weight"] = _t(p["scale"], device, dtype)
    out[f"{prefix}.bias"] = _t(p["bias"], device, dtype)


def from_flax_transformer(params, device="cpu", dtype=torch.float32):
    """flax ``TransformerClassifier`` params -> the port's params dict."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"], device, dtype),
           "pos_embedding": _t(params["pos_embedding"], device, dtype)}
    depth = sum(1 for k in params if k.startswith("EncoderBlock_"))
    for i in range(depth):
        blk = params[f"EncoderBlock_{i}"]
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


def from_flax_mwn(params, device="cpu", dtype=torch.float32):
    """flax ``MetaWeightNet`` params -> the port's params dict."""
    out = {}
    _dense(out, "dense0", params["Dense_0"], device, dtype)
    _dense(out, "dense1", params["Dense_1"], device, dtype)
    return out
