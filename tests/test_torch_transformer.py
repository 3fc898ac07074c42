"""The port's TransformerClassifier and MetaWeightNet against betty_tpu's.

Both sides get the same weights (flax init, moved across with
``betty_tpu_torch.convert``) and the same token ids, padded rows included.
float32: logits within 1e-5, parameter gradients within 1e-4 relative to
max|grad| over all leaves (the key bias has a gradient that is zero up to
rounding, so a bound per leaf would measure noise). bfloat16: logits within
2e-2, the rounding of two frameworks that round at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.models import MetaWeightNet as JMWN
from betty_tpu.models.transformer import TransformerClassifier as JTC
from betty_tpu_torch import convert
from betty_tpu_torch.models import MetaWeightNet, TransformerClassifier
from betty_tpu_torch.utils import tree_cast

VOCAB, DIM, DEPTH, HEADS, S, B = 100, 64, 2, 4, 16, 4


def _ids(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, VOCAB, size=(B, S)).astype(np.int32)
    ids[1, 10:] = 1  # padding (pad_id 1)
    ids[3, 5:] = 1
    return ids


def _pair(use_flash):
    jm = JTC(vocab_size=VOCAB, max_len=S, dim=DIM, depth=DEPTH, heads=HEADS, dropout=0.0,
             use_flash=use_flash)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, S), jnp.int32), train=False)["params"]
    tm = TransformerClassifier(vocab_size=VOCAB, max_len=S, dim=DIM, depth=DEPTH, heads=HEADS,
                               dropout=0.0, use_flash=use_flash)
    tp = convert.from_flax_transformer(jax.tree_util.tree_map(np.asarray, jp))
    assert set(tp) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        assert tuple(tp[n].shape) == tuple(p.shape), n
    return jm, jp, tm, tp


def _loss_weights():
    return np.random.RandomState(1).randn(B, 2).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_and_grads_match_flax(use_flash):
    jm, jp, tm, tp = _pair(use_flash)
    ids, w = _ids(), _loss_weights()

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(ids), train=False)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tout = torch.func.functional_call(tm, tp, (torch.tensor(ids),), {"train": False})
    names = list(tp)
    tgrad = torch.autograd.grad((tout * torch.tensor(w)).sum(), [tp[n] for n in names])

    assert np.max(np.abs(tout.detach().numpy() - np.asarray(jout))) < 1e-5
    jg = convert.from_flax_transformer(jax.tree_util.tree_map(np.asarray, jgrad))
    scale = max(float(np.max(np.abs(g.numpy()))) for g in jg.values())
    for n, g in zip(names, tgrad):
        err = np.max(np.abs(g.numpy() - jg[n].numpy()))
        assert err <= 1e-4 * scale, (n, err, scale)


def test_bf16_forward_matches_flax():
    jm, jp, tm, tp = _pair(True)
    ids = _ids(2)
    jout = jm.apply({"params": jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)},
                    jnp.asarray(ids), train=False)
    tout = torch.func.functional_call(tm, tree_cast(tp, torch.bfloat16),
                                      (torch.tensor(ids),), {"train": False})
    assert tout.dtype == torch.bfloat16
    err = np.max(np.abs(tout.float().numpy() - np.asarray(jout.astype(jnp.float32))))
    assert err < 2e-2


def test_meta_weight_net_matches_flax():
    jm = JMWN()
    jp = jm.init(jax.random.PRNGKey(1), jnp.zeros((8,)))["params"]
    tm = MetaWeightNet()
    tp = convert.from_flax_mwn(jax.tree_util.tree_map(np.asarray, jp))
    x = np.abs(np.random.RandomState(3).randn(8)).astype(np.float32)
    jout = jm.apply({"params": jp}, jnp.asarray(x))
    tout = torch.func.functional_call(tm, tp, (torch.tensor(x),))
    assert np.max(np.abs(tout.numpy() - np.asarray(jout))) < 1e-6


def test_dropout_replays_with_the_same_seed():
    tm = TransformerClassifier(vocab_size=VOCAB, max_len=S, dim=DIM, depth=1, heads=HEADS,
                               dropout=0.1, use_flash=True)
    ids = torch.tensor(_ids())
    a = tm(ids, train=True, rngs={"dropout": 7})
    b = tm(ids, train=True, rngs={"dropout": 7})
    c = tm(ids, train=True, rngs={"dropout": 8})
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="rngs"):
        tm(ids, train=True)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="remat"):
        TransformerClassifier(vocab_size=VOCAB, dim=DIM, depth=1, heads=HEADS, remat=True)


def _attention_pair(rate, heads=2, dim=16, seq=8):
    """flax ``MultiHeadDotProductAttention`` and the port's plain-path
    ``FlashSelfAttention`` with the same weights."""
    import flax.linen as nn

    from betty_tpu_torch.models.transformer import FlashSelfAttention

    mha = nn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=dim,
                                          dropout_rate=rate, deterministic=False)
    x = jnp.zeros((2, seq, dim))
    params = mha.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                      x)["params"]
    att = FlashSelfAttention(heads, dim, use_flash=False, dropout=rate)
    tp = {f"{n}.{w}": torch.tensor(np.asarray(params[n][w]))
          for n in ("query", "key", "value", "out") for w in ("kernel", "bias")}
    return mha, params, att, tp


def test_plain_attention_dropout_mask_is_broadcast():
    """One keep mask over (query, key) for the whole batch, as flax's
    ``broadcast_dropout``: two identical sequences give identical rows."""
    _, _, att, tp = _attention_pair(0.5)
    row = np.random.RandomState(0).randn(1, 8, 16).astype(np.float32)
    x = torch.tensor(np.concatenate([row, row]))
    out = torch.func.functional_call(att, tp, (x,),
                                     {"generator": torch.Generator().manual_seed(3)})
    assert torch.equal(out[0], out[1])
    plain = torch.func.functional_call(att, tp, (x,))
    assert not torch.equal(out, plain)


def test_plain_attention_dropout_matches_flax_in_distribution():
    """Over 400 dropout draws at rate 0.5, with a padded sequence in the
    batch, the per-element mean of the attention sublayer's output agrees
    with flax within 5 standard errors and its variance within 0.35
    relative (about 3.5 standard errors of a sample variance of 400 draws).
    Masks drawn per batch element and head, or left unscaled, fail these
    bounds (relative variance differences above 1.4)."""
    import flax.linen as nn

    n_draws, rate = 400, 0.5
    mha, params, att, tp = _attention_pair(rate)
    x = np.random.RandomState(1).randn(2, 8, 16).astype(np.float32)
    pad = np.ones((2, 8), bool)
    pad[1, 6:] = False
    keys = jax.random.split(jax.random.PRNGKey(2), n_draws)
    mask = nn.make_attention_mask(pad, pad)
    jy = np.asarray(jax.vmap(lambda k: mha.apply(
        {"params": params}, jnp.asarray(x), mask=mask, rngs={"dropout": k}))(keys))
    tx, tpad = torch.tensor(x), torch.tensor(pad)
    ty = np.stack([torch.func.functional_call(
        att, tp, (tx,), {"kv_mask": tpad, "generator": torch.Generator().manual_seed(s)}
    ).detach().numpy() for s in range(n_draws)])
    # padded query rows differ by construction (flax masks them, the port
    # masks keys only; the classifier never reads them)
    valid = np.broadcast_to(pad[:, :, None], jy.shape[1:])
    mj, vj = jy.mean(0)[valid], jy.var(0, ddof=1)[valid]
    mt, vt = ty.mean(0)[valid], ty.var(0, ddof=1)[valid]
    assert np.max(np.abs(mt - mj) / np.sqrt((vt + vj) / n_draws)) < 5.0
    assert np.max(np.abs(vt - vj) / ((vt + vj) / 2)) < 0.35


def test_plain_attention_eval_is_unchanged():
    """Eval mode (no generator) at any dropout rate is the plain attention,
    bit for bit, and the classifier's eval output does not depend on the
    rate."""
    from betty_tpu_torch.ops.flash_attention import reference_attention

    _, _, att, tp = _attention_pair(0.5)
    x = torch.tensor(np.random.RandomState(4).randn(2, 8, 16).astype(np.float32))
    out = torch.func.functional_call(att, tp, (x,))
    q, k, v = (torch.func.functional_call(getattr(att, n), {
        "kernel": tp[f"{n}.kernel"], "bias": tp[f"{n}.bias"]}, (x,))
        for n in ("query", "key", "value"))
    want = torch.func.functional_call(att.out, {"kernel": tp["out.kernel"],
                                                "bias": tp["out.bias"]},
                                      (reference_attention(q, k, v),))
    assert torch.equal(out, want)
    ids = torch.tensor(_ids())
    models = [TransformerClassifier(vocab_size=VOCAB, max_len=S, dim=DIM, depth=1, heads=HEADS,
                                    dropout=rate, use_flash=False) for rate in (0.0, 0.5)]
    assert torch.equal(models[0](ids, train=False), models[1](ids, train=False))
