"""Unified model assembly for all assigned architecture families.

One decoder-LM skeleton with per-family layer bodies (dense / MoE / SSM /
hybrid / VLM backbone / whisper enc-dec), a loop over layers with stacked
params, full-sequence ``forward`` (train/prefill) and O(1) ``decode_step``
with KV / SSM-state / sliding-window-ring caches, slot or paged.

Function for function the reference's ``repro/models/transformer.py`` in
plain torch ops.  ``init_params``, ``init_cache`` and ``init_paged_cache``
target the card unless the caller asks for the CPU; ``forward``,
``decode_step`` and ``decode_chunk`` run where the parameters lie.  Caches
are written in place (the ring slot, or the physical block; inactive rows
write the parking slot or block) and returned, as the reference returns
its new cache.  ``cfg.remat`` (``_remat``) recomputes each layer's
activations in the backward pass with ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` does, and changes no value;
``activation_sharding="sp"`` puts the residual stream under
``constrain_sp`` before the loop and after each layer, as the reference
does (a no-op outside a ``mesh_scope`` and on a rank's plain tensors).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from ..core.device import resolve_device
from . import layers as L
from . import ssm as S
from .module import Creator, Params, layer_slice, stack_layers, tree_leaves, tree_map


# ======================================================================
# parameter construction
# ======================================================================
def layer_params(c: Creator, cfg) -> Params:
    fam = cfg.family
    p: Params = {"ln1": L.rmsnorm_params(c, cfg.d_model)}
    if fam == "ssm":
        p["mamba"] = S.mamba2_params(c, cfg)
        return p
    if fam == "audio":  # whisper decoder layer (pre-LN layernorm, GELU mlp)
        return {
            "ln1": L.layernorm_params(c, cfg.d_model),
            "attn": L.attention_params(c, cfg),
            "lnx": L.layernorm_params(c, cfg.d_model),
            "xattn": L.attention_params(c, cfg),
            "ln2": L.layernorm_params(c, cfg.d_model),
            "mlp": L.gelu_mlp_params(c, cfg.d_model, cfg.d_ff),
        }
    p["attn"] = L.attention_params(c, cfg)
    if fam == "hybrid":
        p["mamba"] = S.mamba2_params(c, cfg)
        p["norm_a"] = L.rmsnorm_params(c, cfg.d_model)
        p["norm_m"] = L.rmsnorm_params(c, cfg.d_model)
    p["ln2"] = L.rmsnorm_params(c, cfg.d_model)
    if fam == "moe":
        p["moe"] = L.moe_params(c, cfg)
    else:
        p["mlp"] = L.swiglu_params(c, cfg.d_model, cfg.d_ff)
    return p


def encoder_layer_params(c: Creator, cfg) -> Params:
    return {
        "ln1": L.layernorm_params(c, cfg.d_model),
        "attn": L.attention_params(c, cfg),
        "ln2": L.layernorm_params(c, cfg.d_model),
        "mlp": L.gelu_mlp_params(c, cfg.d_model, cfg.d_ff),
    }


def model_params(cfg, generator: Optional[torch.Generator] = None,
                 materialize: bool = True, device=None) -> Params:
    c = Creator(generator, cfg.torch_dtype, materialize, device)
    p: Params = {"embed": L.embedding_params(c, cfg)}
    p["layers"] = stack_layers(lambda cc: layer_params(cc, cfg), c, cfg.num_layers)
    if cfg.family == "audio":
        p["ln_f"] = L.layernorm_params(c, cfg.d_model)
        p["enc_layers"] = stack_layers(
            lambda cc: encoder_layer_params(cc, cfg), c, cfg.encoder_layers
        )
        p["enc_ln_f"] = L.layernorm_params(c, cfg.d_model)
    else:
        p["ln_f"] = L.rmsnorm_params(c, cfg.d_model)
    if cfg.family == "vlm":
        p["patch_proj"] = L.linear_params(c, cfg.d_model, cfg.d_model)
    return p


def param_specs(cfg) -> Params:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no memory."""
    return model_params(cfg, materialize=False)


def init_params(cfg, seed: int = 0, device=None) -> Params:
    """Random parameters drawn from ``seed`` on ``device`` (the card unless
    the caller asks for the CPU).  The numbers are not the reference's:
    ``params_from_reference`` carries those across."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model_params(cfg, gen, materialize=True, device=dev)


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def _depth(stacked: Params) -> int:
    return next(tree_leaves(stacked)).shape[0]


# ======================================================================
# full-sequence forward (train / prefill)
# ======================================================================
def _attn_full(p, x, cfg, positions, causal=True, kv_x=None, use_mrope=False,
               positions3=None):
    """x: (B, S, d) -> (B, S, d) attention with online softmax."""
    B, Sq, d = x.shape
    hd, H, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    src = x if kv_x is None else kv_x
    q = L._split_heads(L.linear(p["wq"], x), H, hd)
    k = L._split_heads(L.linear(p["wk"], src), Hkv, hd)
    v = L._split_heads(L.linear(p["wv"], src), Hkv, hd)
    if cfg.family != "audio":  # whisper uses additive sinusoidal positions
        if use_mrope:
            q = L.mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
            k = L.mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)
        elif kv_x is None:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
    o = L.online_attention(
        q, k, v,
        causal=causal and kv_x is None,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        sliding_window=cfg.sliding_window if kv_x is None else 0,
    )
    return L.linear(p["wo"], o.reshape(B, Sq, H * hd))


def _layer_fwd(lp: Params, x, cfg, positions, positions3=None, enc_out=None):
    fam = cfg.family
    if fam == "ssm":
        return x + S.mamba2_forward(lp["mamba"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg)
    if fam == "audio":
        h = L.layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + _attn_full(lp["attn"], h, cfg, positions, causal=True)
        hx = L.layernorm(lp["lnx"], x, cfg.norm_eps)
        x = x + _attn_full(lp["xattn"], hx, cfg, positions, kv_x=enc_out)
        h2 = L.layernorm(lp["ln2"], x, cfg.norm_eps)
        return x + L.gelu_mlp(lp["mlp"], h2)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if fam == "hybrid":
        a = _ckpt_name(_attn_full(lp["attn"], h, cfg, positions), "attn_out", cfg)
        m = S.mamba2_forward(lp["mamba"], h, cfg)
        mix = (
            L.rmsnorm(lp["norm_a"], a, cfg.norm_eps).to(L.F32)
            + L.rmsnorm(lp["norm_m"], m, cfg.norm_eps).to(L.F32)
        ) * 0.5
        x = x + mix.to(x.dtype)
    else:
        x = x + _ckpt_name(_attn_full(lp["attn"], h, cfg, positions,
                                      use_mrope=cfg.mrope, positions3=positions3),
                           "attn_out", cfg)
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if fam == "moe":
        return x + _ckpt_name(L.moe(lp["moe"], h2, cfg), "ffn_out", cfg)
    return x + _ckpt_name(L.swiglu(lp["mlp"], h2), "ffn_out", cfg)


@torch.library.custom_op("repro_torch::ckpt_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that selective remat's policy knows by its op, the
    counterpart of ``jax.ad_checkpoint.checkpoint_name``."""
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))


def _ckpt_name(x, name: str, cfg=None):
    """Tag for selective remat, a no-op otherwise (the tag itself is a
    copy, as the reference's makes XLA materialize the boundary)."""
    if cfg is None or cfg.remat != "selective":
        return x
    return _named(x, name)


#: ``dots`` saves every product (``jax.checkpoint_policies.checkpoint_dots``)
_PRODUCT_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _policy(save):
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if save(op) else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _remat(fn, cfg):
    """``fn`` recomputed in the backward pass (``cfg.remat``): ``none``
    saves everything; ``dots`` saves the products; ``selective`` only the
    layers' ``attn_out``/``ffn_out``; ``full`` (and any other value, as in
    the reference) saves nothing but the layer's inputs.  The layers use
    no randomness, so the RNG state is not kept; without grad ``fn`` runs
    as it is."""
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _policy(lambda op: op in _PRODUCT_OPS))
    elif cfg.remat == "selective":
        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            _policy(lambda op: op is torch.ops.repro_torch.ckpt_name.default))
    else:
        context_fn = noop_context_fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)

    return run


def _scan_layers(stacked, x, body, cfg=None):
    """``body`` over the layers in order, the residual stream carried from
    one to the next.  ``stacked`` is the stacked tree, or a list of one
    tree a layer (the train step's leaves for autograd, whose gradients
    then come a layer apiece instead of each one summed into a zeroed copy
    of the whole stack).  Under ``activation_sharding="sp"`` the stream
    is constrained sequence-parallel before the loop and after each layer
    (``constrain_sp``)."""
    sp = cfg is not None and cfg.activation_sharding == "sp"
    if sp:
        from ..distributed.sharding import constrain_sp

        x = constrain_sp(x)
    if isinstance(stacked, (list, tuple)):
        layers = stacked
    else:
        layers = (layer_slice(stacked, i) for i in range(_depth(stacked)))
    for lp in layers:
        x = body(lp, x)
        if sp:
            x = constrain_sp(x)     # shard the remat stash 'model'-ways
    return x


def mrope_positions(cfg, B: int, S_total: int, device=None):
    """(3, B, S): patches get (0, h, w) on a sqrt grid; text gets (t, t, t)."""
    P = cfg.num_patches
    g = max(1, int(P ** 0.5))
    idx = torch.arange(P, device=device)
    pt = torch.zeros((P,), dtype=torch.int32, device=device)
    ph = (idx // g).to(torch.int32)
    pw = (idx % g).to(torch.int32)
    t_text = torch.arange(S_total - P, dtype=torch.int32, device=device) + g
    three = torch.stack(
        [
            torch.cat([pt, t_text]),
            torch.cat([ph, t_text]),
            torch.cat([pw, t_text]),
        ]
    )                                                   # (3, S)
    return three[:, None, :].expand(3, B, S_total)


def encode_audio(params: Params, frames, cfg):
    """Whisper encoder over stub frame embeddings (B, S_enc, d)."""
    frames = torch.as_tensor(frames, device=_device(params))
    B, Se, d = frames.shape
    x = frames + L.sinusoidal_positions(Se, d, device=frames.device).to(frames.dtype)[None]

    def body(lp, h):
        z = L.layernorm(lp["ln1"], h, cfg.norm_eps)
        h = h + _attn_full(lp["attn"], z, cfg, None, causal=False)
        z2 = L.layernorm(lp["ln2"], h, cfg.norm_eps)
        return h + L.gelu_mlp(lp["mlp"], z2)

    x = _scan_layers(params["enc_layers"], x, _remat(body, cfg), cfg)
    return L.layernorm(params["enc_ln_f"], x, cfg.norm_eps)


def forward(params: Params, batch: Dict[str, Any], cfg,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, padded_vocab) in f32, or the
    pre-unembed hidden states (B, S, d) when ``return_hidden``.  ``batch``
    holds tensors or numpy arrays; it runs on the parameters' device."""
    dev = _device(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S_text = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions3 = None
    enc_out = None
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=dev)
        x = torch.cat([L.linear(params["patch_proj"], patches).to(x.dtype), x], dim=1)
        positions3 = mrope_positions(cfg, B, x.shape[1], dev)
    if cfg.family == "audio":
        enc_out = encode_audio(params, batch["frames"], cfg)
        x = x + L.sinusoidal_positions(S_text, cfg.d_model, device=dev).to(x.dtype)[None]
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)

    def body(lp, h):
        return _layer_fwd(lp, h, cfg, positions, positions3, enc_out)

    x = _scan_layers(params["layers"], x, _remat(body, cfg), cfg)
    if cfg.family == "audio":
        x = L.layernorm(params["ln_f"], x, cfg.norm_eps)
    else:
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, -S_text:]                    # loss over text positions only
    if return_hidden:
        return x
    return L.unembed(params["embed"], x).to(L.F32)


# ======================================================================
# decode path (serving)
# ======================================================================
def _stack_zeros(one: Params, Lh: int) -> Params:
    return tree_map(lambda a: torch.zeros((Lh,) + tuple(a.shape), dtype=a.dtype,
                                          device=a.device), one)


def init_cache(cfg, batch: int, max_len: int, device=None) -> Params:
    """Stacked (L, ...) cache tree on ``device`` (the card unless the caller
    asks for the CPU).  Sliding-window archs use a ring of size
    ``min(window, max_len)``; SSM keeps O(1) state."""
    dev = resolve_device(device)
    Lh, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    cache: Params = {}
    if cfg.family == "ssm":
        cache["mamba"] = _stack_zeros(S.mamba2_init_cache(cfg, batch, dt, dev), Lh)
        return cache
    W = max_len if not cfg.sliding_window else min(cfg.sliding_window, max_len)
    kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dt
    # W ring slots + 1 parking slot for masked (inactive-row) writes
    cache["k"] = torch.zeros((Lh, batch, W + 1, Hkv, hd), dtype=kv_dt, device=dev)
    cache["v"] = torch.zeros((Lh, batch, W + 1, Hkv, hd), dtype=kv_dt, device=dev)
    if cfg.kv_cache_dtype == "int8":
        cache["k_scale"] = torch.zeros((Lh, batch, W + 1, Hkv), dtype=L.F32, device=dev)
        cache["v_scale"] = torch.zeros((Lh, batch, W + 1, Hkv), dtype=L.F32, device=dev)
    if cfg.family == "hybrid":
        cache["mamba"] = _stack_zeros(S.mamba2_init_cache(cfg, batch, dt, dev), Lh)
    if cfg.family == "audio":
        cache["xk"] = torch.zeros((Lh, batch, cfg.encoder_seq, Hkv, hd), dtype=dt, device=dev)
        cache["xv"] = torch.zeros((Lh, batch, cfg.encoder_seq, Hkv, hd), dtype=dt, device=dev)
    return cache


def init_paged_cache(cfg, num_blocks: int, block_size: int,
                     decode_width: int, device=None) -> Params:
    """Paged KV cache: a single (L, num_blocks + 1, block_size, Hkv, hd)
    block pool SHARED by every request (physical block ``num_blocks`` is the
    parking block for masked writes), instead of per-slot contiguous rings.
    SSM/conv state stays per-row O(1) (it does not page), sized by
    ``decode_width``.  On ``device``: the card unless the caller asks for
    the CPU."""
    if cfg.family == "audio":
        raise ValueError(
            "paged KV decode does not support the audio family (the "
            "cross-attention cache is per-row dense, not positional)"
        )
    dev = resolve_device(device)
    Lh, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    cache: Params = {}
    if cfg.family != "ssm":
        kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dt
        shape = (Lh, num_blocks + 1, block_size, Hkv, hd)
        cache["k"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kv_dt, device=dev)
        if cfg.kv_cache_dtype == "int8":
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=L.F32, device=dev)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=L.F32, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        cache["mamba"] = _stack_zeros(S.mamba2_init_cache(cfg, decode_width, dt, dev), Lh)
    return cache


def _write_kv(cache_l, k, v, where, quant: bool):
    """Write this step's k/v (B, Hkv, hd) at ``where`` (index tensors into
    the cache's leading axes) in place: quantized, with their scales, for
    an int8 cache.  Returns the scale planes to read, or (None, None)."""
    if not quant:
        cache_l["k"][where] = k.to(cache_l["k"].dtype)
        cache_l["v"][where] = v.to(cache_l["v"].dtype)
        return None, None
    k8, ks = L.quantize_kv_int8(k)
    v8, vs = L.quantize_kv_int8(v)
    cache_l["k"][where] = k8
    cache_l["v"][where] = v8
    cache_l["k_scale"][where] = ks
    cache_l["v_scale"][where] = vs
    return cache_l["k_scale"], cache_l["v_scale"]


def _attn_decode(p, x, cache_l, pos, cfg, active=None, block_table=None, kv_ring=None):
    """x: (B, d) one token; cache_l holds (B, W + 1, Hkv, hd) ring caches
    (plus (B, W + 1, Hkv) scale planes when the cache is int8-quantized),
    written in place.

    ``pos``: (B,) per-slot absolute positions (continuous batching);
    ``active``: optional (B,) bool write mask.

    With ``block_table`` (B, max_blocks) the cache is PAGED instead:
    ``cache_l["k"]`` is a shared (num_blocks + 1, block_size, Hkv, hd) block
    pool and each row reads/writes through its table (``kv_ring`` is the
    logical ring capacity in tokens)."""
    B, d = x.shape
    hd, H, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = L.linear(p["wq"], x).reshape(B, H, hd)
    k = L.linear(p["wk"], x).reshape(B, Hkv, hd)
    v = L.linear(p["wv"], x).reshape(B, Hkv, hd)
    posb = pos.reshape(B, 1)
    if cfg.family != "audio":
        q = L.rope(q.reshape(B, 1, H, hd), posb, cfg.rope_theta).reshape(B, H, hd)
        k = L.rope(k.reshape(B, 1, Hkv, hd), posb, cfg.rope_theta).reshape(B, Hkv, hd)
    act = active if active is not None else torch.ones((B,), dtype=torch.bool, device=x.device)
    quant = cfg.kv_cache_dtype == "int8"
    if block_table is not None:
        return _paged_kv_attend(p, cache_l, q, k, v, pos, cfg, act, quant,
                                block_table, kv_ring)
    # W ring slots + 1 PARKING slot (index W): inactive rows write the
    # parking slot, which is always beyond ``length``, so attention never
    # reads it
    W = cache_l["k"].shape[1] - 1
    slot = torch.where(act, pos % W, W)
    rows = torch.arange(B, device=x.device)
    k_scale, v_scale = _write_kv(cache_l, k, v, (rows, slot), quant)
    length = torch.clamp(pos + 1, max=W)
    o = L.decode_attention(q, cache_l["k"], cache_l["v"], length, k_scale, v_scale)
    return L.linear(p["wo"], o.reshape(B, H * hd))


def _paged_kv_attend(p, cache_l, q, k, v, pos, cfg, act, quant,
                     block_table, kv_ring: int):
    """Paged read/write for one decode step.

    The pool keeps ``num_blocks`` real blocks + 1 PARKING block (physical
    index ``num_blocks``): inactive rows write there (never read), and
    unassigned table entries point there so the gather below is always
    in-bounds.  Ring arithmetic (``pos % kv_ring``) reuses blocks
    cyclically for sliding-window architectures; attention is permutation-
    invariant over the key axis (RoPE is applied at write time), so ring
    order needs no unscrambling."""
    kc = cache_l["k"]                          # (NB+1, bs, Hkv, hd)
    B = q.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    parking = kc.shape[0] - 1
    bs = kc.shape[1]
    nblk = block_table.shape[1]
    off_tot = pos % kv_ring
    blk = off_tot // bs
    off = off_tot % bs
    phys = torch.gather(block_table, 1, blk[:, None])[:, 0]
    phys = torch.where(act, phys, parking)
    k_scale, v_scale = _write_kv(cache_l, k, v, (phys, off), quant)
    # gather each row's logical view of the pool: (B, nblk*bs, Hkv, hd)
    kb = cache_l["k"][block_table].reshape(B, nblk * bs, kc.shape[2], kc.shape[3])
    vb = cache_l["v"][block_table].reshape(B, nblk * bs, kc.shape[2], kc.shape[3])
    if quant:
        k_scale = k_scale[block_table].reshape(B, nblk * bs, -1)
        v_scale = v_scale[block_table].reshape(B, nblk * bs, -1)
    length = torch.clamp(pos + 1, max=kv_ring)
    o = L.decode_attention(q, kb, vb, length, k_scale, v_scale)
    return L.linear(p["wo"], o.reshape(B, H * hd))


def _mamba_decode(lp, cache_l, h, cfg, active):
    out, new = S.mamba2_decode_step(lp["mamba"], h, cache_l["mamba"], cfg, active)
    cache_l["mamba"]["ssm"].copy_(new["ssm"])
    cache_l["mamba"]["conv"].copy_(new["conv"])
    return out


def _layer_decode(lp, cache_l, x, pos, cfg, active=None, block_table=None,
                  kv_ring=None):
    fam = cfg.family
    if fam == "ssm":
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        return x + _mamba_decode(lp, cache_l, h, cfg, active)
    if fam == "audio":
        if block_table is not None:
            raise ValueError(
                "paged KV decode does not support the audio family (the "
                "cross-attention cache is per-row dense, not positional)"
            )
        h = L.layernorm(lp["ln1"], x, cfg.norm_eps)
        x = x + _attn_decode(lp["attn"], h, cache_l, pos, cfg, active)
        hx = L.layernorm(lp["lnx"], x, cfg.norm_eps)
        B = x.shape[0]
        q = L.linear(lp["xattn"]["wq"], hx).reshape(B, cfg.num_heads, cfg.head_dim)
        Se = cache_l["xk"].shape[1]
        xo = L.decode_attention(q, cache_l["xk"], cache_l["xv"],
                                torch.full((B,), Se, dtype=torch.int64, device=x.device))
        x = x + L.linear(lp["xattn"]["wo"], xo.reshape(B, -1))
        h2 = L.layernorm(lp["ln2"], x, cfg.norm_eps)
        return x + L.gelu_mlp(lp["mlp"], h2)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a = _attn_decode(lp["attn"], h, cache_l, pos, cfg, active, block_table, kv_ring)
    if fam == "hybrid":
        m = _mamba_decode(lp, cache_l, h, cfg, active)
        mix = (
            L.rmsnorm(lp["norm_a"], a, cfg.norm_eps).to(L.F32)
            + L.rmsnorm(lp["norm_m"], m, cfg.norm_eps).to(L.F32)
        ) * 0.5
        x = x + mix.to(x.dtype)
    else:
        x = x + a
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if fam == "moe":
        # decode uses dense-mode routing (few tokens; no capacity dispatch)
        return x + L.moe_dense(lp["moe"], h2[:, None, :], cfg)[:, 0]
    return x + L.swiglu(lp["mlp"], h2)


def _rows(value, B: int, dtype, device) -> torch.Tensor:
    """A scalar or (B,) value as a (B,) tensor on ``device``."""
    return torch.as_tensor(value, device=device).to(dtype).expand(B)


def decode_step(params: Params, cache: Params, tokens, pos, cfg, active=None,
                block_tables=None, kv_ring=None):
    """tokens: (B,) int newest tokens; pos: () or (B,) absolute positions
    (per-slot for continuous batching); active: optional (B,) write mask.

    With ``block_tables`` (B, max_blocks) int the cache must come from
    ``init_paged_cache`` and ``kv_ring`` (int) is the logical ring capacity
    in tokens — the paged continuous-batching read/write path.

    Returns (logits (B, padded_vocab) f32, cache), the cache written in
    place.
    """
    dev = _device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    B = tokens.shape[0]
    pos = _rows(pos, B, torch.int64, dev)
    if active is not None:
        active = _rows(active, B, torch.bool, dev)
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, device=dev).to(torch.int64)
    x = L.embed(params["embed"], tokens)               # (B, d)
    for i in range(_depth(params["layers"])):
        x = _layer_decode(layer_slice(params["layers"], i), layer_slice(cache, i), x,
                          pos, cfg, active, block_tables, kv_ring)
    if cfg.family == "audio":
        x = L.layernorm(params["ln_f"], x, cfg.norm_eps)
    else:
        x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x).to(L.F32), cache


def decode_chunk(params: Params, cache: Params, tokens, pos, cfg,
                 active=None, lengths=None, block_tables=None, kv_ring=None):
    """Token-chunk decode: ``tokens`` (B, C) int, ``pos`` (B,) chunk-start
    absolute positions, ``lengths`` optional (B,) valid token counts within
    the chunk (ragged tails; default C), ``active`` optional (B,) slot mask.

    Step for step the same computation as C ``decode_step`` calls.
    Positions past a slot's ``lengths`` are masked out of the cache write
    exactly like an inactive slot.

    Returns (logits (B, padded_vocab) f32 taken at each slot's LAST valid
    position, cache); inactive or zero-length slots return zeros.
    """
    dev = _device(params)
    tokens = torch.as_tensor(tokens, device=dev)
    B, C = tokens.shape
    pos = _rows(pos, B, torch.int64, dev)
    act = (torch.ones((B,), dtype=torch.bool, device=dev) if active is None
           else _rows(active, B, torch.bool, dev))
    lengths = (torch.full((B,), C, dtype=torch.int64, device=dev) if lengths is None
               else _rows(lengths, B, torch.int64, dev))
    padded_vocab = params["embed"]["unembed"].shape[-1]
    last = torch.zeros((B, padded_vocab), dtype=L.F32, device=dev)
    for i in range(C):
        step_act = act & (i < lengths)
        logits, cache = decode_step(params, cache, tokens[:, i], pos + i, cfg,
                                    step_act, block_tables, kv_ring)
        keep = (step_act & (i == lengths - 1))[:, None]
        last = torch.where(keep, logits, last)
    return last, cache


def prefill_cross_attention(params: Params, frames, cfg, batch: int):
    """Whisper: run the encoder and precompute per-layer cross K/V, each
    (L, B, S_enc, Hkv, hd) in the config's dtype."""
    enc = encode_audio(params, frames, cfg)            # (B, Se, d)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    ks, vs = [], []
    for i in range(_depth(params["layers"])):
        xattn = layer_slice(params["layers"], i)["xattn"]
        ks.append(L._split_heads(L.linear(xattn["wk"], enc), Hkv, hd))
        vs.append(L._split_heads(L.linear(xattn["wv"], enc), Hkv, hd))
    dt = cfg.torch_dtype
    return torch.stack(ks).to(dt), torch.stack(vs).to(dt)
