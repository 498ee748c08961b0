"""The port's decode path (``repro_torch.models``: ``decode_step``,
``decode_chunk``, the slot cache, the paged cache, the int8 cache and
Whisper's cross-attention) against the reference's, on the CPU.

The reference's weights (``repro.models.init_params``) are carried across
by ``params_from_reference``; both run the same tokens, positions, masks
and block tables, and every step's logits and the caches after it are
held at ``TOL`` (float32).  The port writes its caches in place, so each
side starts from its own zeros.  int8 cache entries may differ by one
step where a value sits on a rounding edge (``INT8_STEPS``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.models import layers as rL
from repro.models import transformer as rtransformer
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels

ARCHS = ["qwen2.5-14b", "mamba2-1.3b", "hymba-1.5b", "granite-moe-3b-a800m"]
#: float32 logits and caches, rtol = atol (measured: under 5e-6)
TOL = 2e-5
#: int8 cache entries: at most this far from the reference's, and rarely
INT8_STEPS = 1


def _setup(arch, seed=0, **kw):
    rcfg = rconfigs.reduced_config(rconfigs.get_config(arch), **kw)
    tcfg = tconfigs.reduced_config(tconfigs.get_config(arch), **kw)
    rparams = rmodels.init_params(rcfg, seed)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    return rcfg, tcfg, rparams, tparams


@functools.lru_cache(maxsize=None)
def _ref_fns(arch, kv_ring, **kw):
    """The reference's decode_step and decode_chunk, jitted for one config
    (``kv_ring`` static)."""
    cfg = rconfigs.reduced_config(rconfigs.get_config(arch), **kw)
    step = jax.jit(lambda p, c, t, pos, act, bt: rmodels.decode_step(p, c, t, pos, cfg, act, bt, kv_ring))
    chunk = jax.jit(lambda p, c, t, pos, act, lens, bt: rmodels.decode_chunk(
        p, c, t, pos, cfg, act, lens, bt, kv_ring))
    return step, chunk


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _caches_close(tcache, rcache, parking_block=None):
    """Every cache leaf against the reference's.  ``parking_block``: leave out
    that physical block of a paged pool, where several inactive rows may
    write one slot and either write may land."""
    ref = dict(_leaves(rcache))
    got = dict(_leaves(tcache))
    assert set(got) == set(ref)
    for name, want in ref.items():
        g, w = _np(got[name]), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if parking_block is not None and name.split("/")[-1] in ("k", "v", "k_scale", "v_scale"):
            g, w = g[:, :parking_block], w[:, :parking_block]
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= INT8_STEPS and (diff > 0).mean() < 1e-2, name
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


def _tokens(B, n, seed=0):
    return np.random.RandomState(seed).randint(0, 200, (B, n)).astype(np.int32)


# ---------------------------------------------------------------- slot cache
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference(arch):
    """Per-row positions, a row inactive on some steps; 12 steps run the
    hybrid's ring (window 8) past its window."""
    rcfg, tcfg, rparams, tparams = _setup(arch)
    step, _ = _ref_fns(arch, None)
    B = 3
    rcache = rmodels.init_cache(rcfg, B, max_len=32)
    tcache = tmodels.init_cache(tcfg, B, max_len=32, device="cpu")
    toks = _tokens(B, 12)
    start = np.array([0, 5, 2], np.int32)
    for i in range(12):
        pos = start + i
        act = np.array([True, i % 3 != 1, i < 9])
        want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i]), jnp.asarray(pos),
                            jnp.asarray(act), None)
        got, tcache = tmodels.decode_step(tparams, tcache, toks[:, i], pos, tcfg, act)
        _close(got, want)
    _caches_close(tcache, rcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_matches_the_reference(arch):
    """Two chunks: ragged ``lengths`` (one of them 0), one row inactive."""
    rcfg, tcfg, rparams, tparams = _setup(arch)
    _, chunk = _ref_fns(arch, None)
    B, C = 4, 6
    rcache = rmodels.init_cache(rcfg, B, max_len=32)
    tcache = tmodels.init_cache(tcfg, B, max_len=32, device="cpu")
    act = np.array([True, True, False, True])
    lengths = np.array([6, 3, 6, 0], np.int32)
    pos = np.zeros(B, np.int32)
    for c in range(2):
        toks = _tokens(B, C, seed=c)
        want, rcache = chunk(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(act), jnp.asarray(lengths), None)
        got, tcache = tmodels.decode_chunk(tparams, tcache, toks, pos, tcfg, act, lengths)
        _close(got, want)
        assert not got[2].any() and not got[3].any()     # inactive, zero-length: zeros
        pos = pos + lengths
    _caches_close(tcache, rcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own invariant, as the reference's
    ``test_decode_matches_forward``: decode logits equal the full forward's
    at every position."""
    _, cfg, _, params = _setup(arch)
    B, S = 2, 8
    toks = _tokens(B, S)
    full = tmodels.forward(params, {"tokens": toks}, cfg)
    cache = tmodels.init_cache(cfg, B, max_len=32, device="cpu")
    outs = []
    for i in range(S):
        logits, cache = tmodels.decode_step(params, cache, toks[:, i], i, cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_decode_writes_the_cache_in_place_and_parks_inactive_rows():
    _, cfg, _, params = _setup("qwen2.5-14b")
    cache = tmodels.init_cache(cfg, 2, max_len=8, device="cpu")
    k = cache["k"]
    _, out = tmodels.decode_step(params, cache, np.array([3, 4]), np.array([2, 5]), cfg,
                                 active=np.array([True, False]))
    assert out is cache and out["k"] is k
    assert k[:, 0, 2].abs().sum() > 0                 # row 0 wrote its ring slot 2
    assert k[:, 1, :8].abs().sum() == 0               # row 1 wrote no ring slot...
    assert k[:, 1, 8].abs().sum() > 0                 # ...but its parking slot


# ------------------------------------------------------------------ int8 KV
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "hymba-1.5b"])
def test_int8_kv_cache_matches_the_reference(arch):
    rcfg, tcfg, rparams, tparams = _setup(arch, kv_cache_dtype="int8")
    step, _ = _ref_fns(arch, None, kv_cache_dtype="int8")
    B = 2
    rcache = rmodels.init_cache(rcfg, B, max_len=16)
    tcache = tmodels.init_cache(tcfg, B, max_len=16, device="cpu")
    assert tcache["k"].dtype == torch.int8 and "k_scale" in tcache
    toks = _tokens(B, 10)
    for i in range(10):
        pos = np.array([i, i + 1], np.int32)
        act = np.array([True, i != 4])
        want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i]), jnp.asarray(pos),
                            jnp.asarray(act), None)
        got, tcache = tmodels.decode_step(tparams, tcache, toks[:, i], pos, tcfg, act)
        _close(got, want)
    _caches_close(tcache, rcache)


# ----------------------------------------------------------------- whisper
def test_whisper_cross_attention_and_decode_match_the_reference():
    rcfg, tcfg, rparams, tparams = _setup("whisper-base")
    step, chunk = _ref_fns("whisper-base", None)
    B = 2
    frames = np.random.RandomState(1).randn(B, rcfg.encoder_seq, rcfg.d_model).astype(np.float32) * 0.02
    # the reference's prefill_cross_attention raises (its scan body takes
    # (carry, layer) as (layer, carry)): its cross K/V are built here from
    # the reference's encoder and per-layer projections, as its docstring says
    with pytest.raises(TypeError):
        rmodels.prefill_cross_attention(rparams, jnp.asarray(frames), rcfg, B)
    enc = rtransformer.encode_audio(rparams, jnp.asarray(frames), rcfg)
    xattn = rparams["layers"]["xattn"]
    rk, rv = (jnp.stack([rL._split_heads(rL.linear({"w": xattn[w]["w"][i]}, enc),
                                         rcfg.num_kv_heads, rcfg.head_dim)
                         for i in range(rcfg.num_layers)])
              for w in ("wk", "wv"))
    tk, tv = tmodels.prefill_cross_attention(tparams, frames, tcfg, B)
    assert tk.shape == (rcfg.num_layers, B, rcfg.encoder_seq, rcfg.num_kv_heads, rcfg.head_dim)
    _close(tk, rk)
    _close(tv, rv)
    rcache = dict(rmodels.init_cache(rcfg, B, max_len=16), xk=rk, xv=rv)
    tcache = tmodels.init_cache(tcfg, B, max_len=16, device="cpu")
    tcache["xk"].copy_(tk)
    tcache["xv"].copy_(tv)
    toks = _tokens(B, 9)
    want, rcache = chunk(rparams, rcache, jnp.asarray(toks[:, :5]), jnp.zeros(B, jnp.int32),
                         jnp.ones(B, bool), jnp.asarray([5, 4]), None)
    got, tcache = tmodels.decode_chunk(tparams, tcache, toks[:, :5], 0, tcfg, lengths=[5, 4])
    _close(got, want)
    for i in range(5, 9):
        pos = np.array([i, i - 1], np.int32)
        want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i]), jnp.asarray(pos),
                            jnp.ones(B, bool), None)
        got, tcache = tmodels.decode_step(tparams, tcache, toks[:, i], pos, tcfg)
        _close(got, want)
    _caches_close(tcache, rcache)


def test_paged_cache_refuses_the_audio_family():
    _, cfg, _, params = _setup("whisper-base")
    with pytest.raises(ValueError, match="audio"):
        tmodels.init_paged_cache(cfg, 4, 4, 2, device="cpu")
    cache = tmodels.init_cache(cfg, 2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="audio"):
        tmodels.decode_step(params, cache, np.array([1, 2]), 0, cfg,
                            block_tables=np.zeros((2, 2), np.int32), kv_ring=8)


# ---------------------------------------------------------------- paged cache
#: mamba2 keeps no KV cache, so it has no int8 case
PAGED_CASES = [(a, kv) for a in ARCHS for kv in ("model", "int8")
               if not (a == "mamba2-1.3b" and kv == "int8")]


def _paged_layout(cfg, B, max_len, bs, seed=0):
    """The serving engine's layout: a ring of ``kv_ring`` tokens a row, its
    blocks dealt from a shuffled pool with one block to spare."""
    kv_ring = max_len if not cfg.sliding_window else min(cfg.sliding_window, max_len)
    nblk = -(-kv_ring // bs)
    num_blocks = B * nblk + 1
    phys = np.random.RandomState(seed).permutation(num_blocks)[: B * nblk]
    tables = phys.reshape(B, nblk).astype(np.int32)
    return kv_ring, num_blocks, tables


@pytest.mark.parametrize("arch,kv", PAGED_CASES)
def test_paged_decode_matches_the_reference(arch, kv):
    rcfg, tcfg, rparams, tparams = _setup(arch, kv_cache_dtype=kv)
    B, bs, C = 3, 4, 5
    kv_ring, num_blocks, tables = _paged_layout(rcfg, B, 16, bs)
    tables[2] = num_blocks                              # the inactive row: parked
    step, chunk = _ref_fns(arch, kv_ring, kv_cache_dtype=kv)
    rcache = rmodels.init_paged_cache(rcfg, num_blocks, bs, B)
    tcache = tmodels.init_paged_cache(tcfg, num_blocks, bs, B, device="cpu")
    act = np.array([True, True, False])
    lengths = np.array([5, 2, 5], np.int32)
    pos = np.zeros(B, np.int32)
    for c in range(2):                                  # 10 tokens: past the hybrid's window of 8
        toks = _tokens(B, C, seed=c)
        want, rcache = chunk(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(act), jnp.asarray(lengths), jnp.asarray(tables))
        got, tcache = tmodels.decode_chunk(tparams, tcache, toks, pos, tcfg, act, lengths,
                                           tables, kv_ring)
        _close(got, want)
        pos = pos + lengths
    toks = _tokens(B, 1, seed=9)[:, 0]
    want, rcache = step(rparams, rcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(act),
                        jnp.asarray(tables))
    got, tcache = tmodels.decode_step(tparams, tcache, toks, pos, tcfg, act, tables, kv_ring)
    _close(got, want)
    _caches_close(tcache, rcache, parking_block=num_blocks)


@pytest.mark.parametrize("arch,kv", PAGED_CASES)
def test_paged_matches_the_slot_cache_bit_for_bit(arch, kv):
    """The port's paged decode against its own slot decode on the same
    chunks.  Bit for bit where the two read views have one length: the slot
    ring's W + 1 slots (its parking slot included) equal the paged view's
    blocks x block size, so every reduction runs over one shape (ring 15 in
    blocks of 4; the hybrid's window of 8 in blocks of 3)."""
    _, cfg, _, params = _setup(arch, kv_cache_dtype=kv)
    B = 3
    bs = 3 if cfg.sliding_window else 4
    kv_ring, num_blocks, tables = _paged_layout(cfg, B, 15, bs, seed=1)
    if cfg.family != "ssm":
        assert tables.shape[1] * bs == kv_ring + 1
    slot = tmodels.init_cache(cfg, B, max_len=15, device="cpu")
    paged = tmodels.init_paged_cache(cfg, num_blocks, bs, B, device="cpu")
    act = np.array([True, False, True])
    lengths = np.array([6, 6, 4], np.int32)
    pos = np.zeros(B, np.int32)
    for c in range(2):
        toks = _tokens(B, 6, seed=c)
        a, slot = tmodels.decode_chunk(params, slot, toks, pos, cfg, act, lengths)
        b, paged = tmodels.decode_chunk(params, paged, toks, pos, cfg, act, lengths, tables, kv_ring)
        assert torch.equal(a, b), c
        pos = pos + lengths
