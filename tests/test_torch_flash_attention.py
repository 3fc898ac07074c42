"""The port's attention op against betty_tpu's flash attention.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_flash_attention.py runs them. The port's ``flash_attention`` on a
CPU tensor goes through ``FlashAttentionFn`` with the kernels' plain
versions, so these tests hold the arithmetic the CUDA kernels repeat: the
single-tile path (B1/B2, ``_fwd_single_plain`` / ``_bwd_single_plain``) at
S96 with the default blocks, and the multi-tile path (B3-B5,
``_fwd_multi_plain`` / ``_bwd_dkv_plain`` / ``_bwd_dq_plain``) at S96 with
blocks smaller than the sequence and at S1024 with the default 512 blocks.
Tolerances are those of tests/test_flash_attention.py: float32 1e-5
forward, 1e-4 for gradients relative to max|grad|; bfloat16 forward 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betty_tpu.ops import flash_attention as jfa
from betty_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 96, 16

# (sequence, block_q, block_kv): None = the default blocks, min(512, S)
SINGLE = (S, None, None)
TILES = [
    SINGLE,
    (S, 32, 32),  # multi-tile, three tiles each way
    (S, 32, 48),  # unequal tiles: causal tile skips at other places
    (1024, None, None),  # the long-sequence path at the default 512 blocks
]


def _tiles_id(t):
    return f"S{t[0]}" + ("" if t[1] is None else f"-q{t[1]}-kv{t[2]}")


def _inputs(seed, masked_row=False, pad=False, S=S):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = None
    if pad or masked_row:
        mask = np.ones((B, S), bool)
        mask[0, S - 20:] = False
        if masked_row:
            mask[1, :] = False  # every key of batch 1 masked: o = 0, lse = 0
    return q, k, v, w, mask


CASES = [
    dict(causal=False, pad=False, masked_row=False),
    dict(causal=False, pad=True, masked_row=False),
    dict(causal=True, pad=False, masked_row=False),
    dict(causal=True, pad=True, masked_row=False),
    dict(causal=False, pad=False, masked_row=True),
]


def _jax_run(q, k, v, w, mask, causal, blocks=(None, None)):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, jm, causal=causal, block_q=blocks[0],
                                block_kv=blocks[1])
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _torch_run(fn, q, k, v, w, mask, causal, **blocks):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    o = fn(qt, kt, vt, tm, causal=causal, **blocks)
    grads = torch.autograd.grad((o * torch.tensor(w)).sum(), (qt, kt, vt))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _case_id(case):
    return "-".join(k for k, x in case.items() if x) or "plain"


# single-tile ids carry no tile suffix
MATCH_CASES = [
    pytest.param(case, fn, tiles, id=f"{fn}-{_case_id(case)}"
                 + ("" if tiles == SINGLE else f"-{_tiles_id(tiles)}"))
    for tiles in TILES for case in CASES for fn in ("flash_attention", "reference_attention")
]


@pytest.mark.parametrize("case,fn,tiles", MATCH_CASES)
def test_matches_jax_flash_attention(case, fn, tiles):
    seq, bq, bkv = tiles
    q, k, v, w, mask = _inputs(0, pad=case["pad"], masked_row=case["masked_row"], S=seq)
    jo, jg = _jax_run(q, k, v, w, mask, case["causal"], (bq, bkv))
    blocks = dict(block_q=bq, block_kv=bkv) if fn == "flash_attention" else {}
    to, tg = _torch_run(getattr(tfa, fn), q, k, v, w, mask, case["causal"], **blocks)
    assert np.max(np.abs(to - jo)) < 1e-5
    for a, b in zip(tg, jg):
        assert np.max(np.abs(a - b)) <= 1e-4 * max(np.max(np.abs(b)), 1e-6)
    if case["masked_row"]:
        assert np.all(to[1] == 0.0)


def test_lse_matches_jax_single_tile_kernel():
    q, k, v, _, mask = _inputs(1, pad=True, masked_row=True)
    jo, jlse = jfa._fwd_single(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), causal=False,
                               sm_scale=1.0 / np.sqrt(D), interpret=True)
    to, tlse = tfa._fwd_single(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               torch.tensor(mask), causal=False, sm_scale=1.0 / np.sqrt(D))
    assert np.max(np.abs(to.numpy() - np.asarray(jo))) < 1e-5
    assert np.max(np.abs(tlse.numpy() - np.asarray(jlse)[..., 0])) < 1e-5
    assert np.all(tlse.numpy()[1] == 0.0)


@pytest.mark.parametrize("tiles", TILES[1:], ids=_tiles_id)
def test_lse_matches_jax_multi_tile_kernel(tiles):
    """B3's o and lse against JAX's ``_fwd`` (``_fwd_kernel``) with the same
    blocks: padded keys, a fully masked row (o = 0, lse = 0) and, at S96,
    causal tile skips."""
    seq, bq, bkv = tiles
    bq, bkv = bq or 512, bkv or 512
    q, k, v, _, mask = _inputs(1, pad=True, masked_row=True, S=seq)
    for causal in (False, True):
        jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                            causal=causal, sm_scale=1.0 / np.sqrt(D), block_q=bq,
                            block_kv=bkv, interpret=True)
        to, tlse = tfa._fwd_multi(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  torch.tensor(mask), causal=causal,
                                  sm_scale=1.0 / np.sqrt(D), block_q=bq, block_kv=bkv)
        assert np.max(np.abs(to.numpy() - np.asarray(jo))) < 1e-5
        assert np.max(np.abs(tlse.numpy() - np.asarray(jlse)[..., 0])) < 1e-5
        assert np.all(tlse.numpy()[1] == 0.0) and np.all(to.numpy()[1] == 0.0)


def _check_bf16_forward(seq, bq, bkv):
    q, k, v, _, mask = _inputs(2, pad=True, S=seq)
    cast = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    jo = jfa.flash_attention(cast(q), cast(k), cast(v), jnp.asarray(mask), block_q=bq,
                             block_kv=bkv)
    to = tfa.flash_attention(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                             torch.tensor(mask), block_q=bq, block_kv=bkv)
    assert to.dtype == torch.bfloat16
    err = np.max(np.abs(to.float().numpy() - np.asarray(jo.astype(jnp.float32))))
    assert err < 1e-2


def test_bf16_forward_matches_jax():
    _check_bf16_forward(*SINGLE)


@pytest.mark.parametrize("tiles", TILES[1:], ids=_tiles_id)
def test_bf16_multi_tile_forward_matches_jax(tiles):
    _check_bf16_forward(*tiles)


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _to_torch_bf16(x):
    """A JAX or numpy array as a torch bf16 tensor (exact for bf16 values)."""
    return torch.tensor(np.asarray(jnp.asarray(x).astype(jnp.float32))).to(torch.bfloat16)


# (sequence, head dim, causal, padded keys) of the bf16 single-tile backward
BF16_SINGLE_BWD = [(16, 64, False, False), (128, 64, False, False), (96, 16, True, True)]


@pytest.mark.parametrize("seq,dim,causal,pad", BF16_SINGLE_BWD,
                         ids=lambda x: None if isinstance(x, bool) else str(x))
def test_bf16_single_tile_backward_matches_jax_kernel(seq, dim, causal, pad):
    """The plain bf16 B2 (``_bwd_single_plain``, what the tensor-core kernel
    repeats) against JAX's interpret-mode ``_bwd_single`` on JAX's own o and
    lse: di in float32 from the bf16 o and do, p and ds rounded to bf16 at
    the same places, so only the order of float32 sums differs; within
    5e-3 x max|ref| (a flipped bf16 ulp on p or ds moves a gradient by about
    4e-3 of its largest element)."""
    rng = np.random.RandomState(12)
    q, k, v, do = (rng.randn(B, H, seq, dim).astype(np.float32) for _ in range(4))
    mask = None
    if pad:
        mask = np.ones((B, seq), bool)
        mask[0, seq - 20:] = False
    jm = None if mask is None else jnp.asarray(mask)
    kw = dict(causal=causal, sm_scale=1.0 / np.sqrt(dim))
    jo, jlse = jfa._fwd_single(_bf16(q), _bf16(k), _bf16(v), jm, interpret=True, **kw)
    jgrads = jfa._bwd_single(_bf16(q), _bf16(k), _bf16(v), _bf16(do), jo, jlse, jm,
                             interpret=True, **kw)
    tgrads = tfa._bwd_single_plain(
        *(_to_torch_bf16(x) for x in (q, k, v, do, jo)), torch.tensor(np.asarray(jlse)[..., 0]),
        None if mask is None else torch.tensor(mask), **kw)
    for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == torch.bfloat16, name
        ref = np.asarray(want.astype(jnp.float32))
        err = np.max(np.abs(got.float().numpy() - ref))
        assert err <= 5e-3 * np.max(np.abs(ref)), (name, err)


def test_bf16_single_tile_forward_rounds_p_against_the_row_max_as_jax():
    """bf16 B1 must round p against each row's max, as JAX's
    ``_fwd_single_kernel`` does: at S128 D64 with padded keys, the old
    kernel's rounding points, p rounded against a running max over 64-key
    chunks and rescaled (``_fwd_multi_plain`` with ``block_kv=64``), give an
    o that differs from JAX's interpret-mode ``_fwd_single`` in more
    elements than ``_fwd_single_plain``, which repeats JAX's points and
    which the kernel now matches."""
    seq, dim = 128, 64
    rng = np.random.RandomState(21)
    q, k, v = (rng.randn(B, H, seq, dim).astype(np.float32) for _ in range(3))
    mask = np.ones((B, seq), bool)
    mask[0, seq - 20:] = False
    mask[1, seq // 3:] = False
    kw = dict(causal=False, sm_scale=1.0 / np.sqrt(dim))
    jo, _ = jfa._fwd_single(_bf16(q), _bf16(k), _bf16(v), jnp.asarray(mask), interpret=True,
                            **kw)
    ref = np.asarray(jo.astype(jnp.float32))
    args = (*(_to_torch_bf16(x) for x in (q, k, v)), torch.tensor(mask))
    row_max, _ = tfa._fwd_single_plain(*args, **kw)
    running_max, _ = tfa._fwd_multi_plain(*args, block_q=seq, block_kv=64, **kw)
    n_row = int(np.sum(row_max.float().numpy() != ref))
    n_running = int(np.sum(running_max.float().numpy() != ref))
    assert n_running > n_row, (n_running, n_row)


@pytest.mark.parametrize("tiles", [(S, 32, 32), (1024, None, None)], ids=_tiles_id)
def test_bf16_lse_matches_jax_multi_tile_kernel(tiles):
    """The plain bf16 B3 (``_fwd_multi_plain``) against JAX's interpret-mode
    ``_fwd`` with the same blocks, padded keys and a fully masked row: lse
    within 1e-5 x max(1, max|lse|), since both sum the unrounded float32 p
    of float32 scores; o within 1e-2, as the bf16 forward; the masked row
    gives o = 0 and lse = 0."""
    seq, bq, bkv = tiles
    bq, bkv = bq or 512, bkv or 512
    q, k, v, _, mask = _inputs(1, pad=True, masked_row=True, S=seq)
    kw = dict(causal=False, sm_scale=1.0 / np.sqrt(D), block_q=bq, block_kv=bkv)
    jo, jlse = jfa._fwd(_bf16(q), _bf16(k), _bf16(v), jnp.asarray(mask), interpret=True, **kw)
    to, tlse = tfa._fwd_multi(*(_to_torch_bf16(x) for x in (q, k, v)), torch.tensor(mask), **kw)
    assert to.dtype == torch.bfloat16
    jl = np.asarray(jlse)[..., 0]
    assert np.max(np.abs(tlse.numpy() - jl)) <= 1e-5 * max(1.0, np.max(np.abs(jl)))
    assert np.max(np.abs(to.float().numpy() - np.asarray(jo.astype(jnp.float32)))) < 1e-2
    assert np.all(tlse.numpy()[1] == 0.0) and np.all(to.float().numpy()[1] == 0.0)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    """Single-tile and multi-tile paths alike."""
    tfa.reset_launch_counts()
    q, k, v, w, _ = _inputs(3)
    for _, bq, bkv in (SINGLE, (S, 32, 32)):
        _torch_run(tfa.flash_attention, q, k, v, w, None, False, block_q=bq, block_kv=bkv)
    assert {name: f.launches for name, f in tfa.KERNELS.items()} == dict.fromkeys(tfa.KERNELS, 0)


@pytest.mark.parametrize("tiles,path", [
    ((S, None, None), "single"),
    ((S, 96, 96), "single"),
    ((S, 128, 512), "single"),
    ((S, 32, 32), "multi"),
    ((S, 96, 48), "multi"),
    ((S, 48, 96), "multi"),
    ((1024, None, None), "multi"),
], ids=lambda x: _tiles_id(x) if isinstance(x, tuple) else x)
def test_dispatch_is_jax_single_tile_predicate(tiles, path, monkeypatch):
    """Single tile iff Sq <= block_q and Skv <= block_kv (JAX's
    ``_single_tile``), and the backward takes the forward's branch."""
    seq, bq, bkv = tiles
    calls = []
    for name in ("_fwd_single", "_bwd_single", "_fwd_multi", "_bwd_dkv", "_bwd_dq"):
        def spy(*a, _orig=getattr(tfa, name), _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(tfa, name, spy)
    q, k, v, w, _ = _inputs(7, S=seq)
    _torch_run(tfa.flash_attention, q, k, v, w, None, True, block_q=bq, block_kv=bkv)
    want = (["_fwd_single", "_bwd_single"] if path == "single"
            else ["_fwd_multi", "_bwd_dkv", "_bwd_dq"])
    assert calls == want
    assert jfa._single_tile(seq, seq, bq or min(512, seq), bkv or min(512, seq)) == (
        path == "single")


def test_long_sequence_on_cuda_path_raises():
    """A sequence that does not divide by its block raises JAX's own
    ValueError, on the CPU and on any other device, before any kernel is
    chosen; a meta tensor on the multi-tile path has no kernel."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 1, 640, 16).astype(np.float32)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x))
    assert "640" in str(jerr.value) and "512" in str(jerr.value)
    for device in ("cpu", "meta"):
        q = torch.tensor(x, device=device)
        with pytest.raises(ValueError) as terr:
            tfa.flash_attention(q, q, q)
        assert str(terr.value) == str(jerr.value)
    long = torch.empty(1, 1, 1024, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tfa.flash_attention(long, long, long)
    for wrapper in (tfa._fwd_multi, tfa._fwd_single):
        with pytest.raises(RuntimeError, match="no kernel"):
            wrapper(long, long, long, None, causal=False, sm_scale=0.125, **(
                dict(block_q=512, block_kv=512) if wrapper is tfa._fwd_multi else {}))


def test_forward_mode_raises():
    q, k, v, _, _ = _inputs(4)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    with pytest.raises((RuntimeError, NotImplementedError)):
        torch.func.jvp(lambda a: tfa.flash_attention(a, kt, vt), (qt,), (torch.ones_like(qt),))
