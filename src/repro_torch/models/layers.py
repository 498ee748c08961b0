"""Layer library: norms, rotary embeddings (RoPE / M-RoPE / sinusoidal),
GQA attention (online-softmax chunked for long sequences, cache decode,
sliding window, cross attention), SwiGLU/GELU MLPs, and MoE (dense smoke
mode + capacity-based scatter dispatch).

Plain torch ops, function for function the reference's
(``repro/models/layers.py``), with the same dtypes: products promote their
operands as ``jnp.einsum`` does (``einsum``), norms and softmaxes compute
in float32.  Every tensor a function makes lies on its inputs' device.
The reference's sharding constraints are ``_constrain_last_dim_model`` and
``_constrain_rows_model``: inside a ``mesh_scope`` they redistribute a
``DTensor`` as the reference constrains its array, and return a plain
tensor (a rank's own value in SPMD) as it is.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .module import Creator, Params

NEG_INF = -1e30
F32 = torch.float32


def einsum(eq: str, *operands):
    """``torch.einsum`` over operands promoted to one dtype, as
    ``jnp.einsum`` promotes them (torch's refuses mixed dtypes)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(eq, *(o.to(dt) for o in operands))


# ------------------------------------------------------------------- norms
def rmsnorm_params(c: Creator, d: int) -> Params:
    return {"gamma": c.param((d,), "ones", dtype=F32)}


def rmsnorm(p: Params, x, eps: float = 1e-6):
    x32 = x.to(F32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * p["gamma"]).to(x.dtype)


def layernorm_params(c: Creator, d: int) -> Params:
    return {
        "gamma": c.param((d,), "ones", dtype=F32),
        "beta": c.param((d,), "zeros", dtype=F32),
    }


def layernorm(p: Params, x, eps: float = 1e-6):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)   # jnp.var: ddof 0
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]).to(x.dtype)


# ------------------------------------------------------------------ linear
def linear_params(c: Creator, d_in: int, d_out: int, bias: bool = False) -> Params:
    p = {"w": c.param((d_in, d_out), "fan_in")}
    if bias:
        p["b"] = c.param((d_out,), "zeros", dtype=F32)
    return p


def linear(p: Params, x):
    y = einsum("...d,df->...f", x, p["w"])
    if "b" in p:
        y = (y.to(F32) + p["b"]).to(y.dtype)
    return y


# ----------------------------------------------------------------- rotary
def _freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(0, half, dtype=F32, device=device) / half)


def _rotate(x, ang):
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = _freqs(x.shape[-1] // 2, theta, x.device)
    ang = positions[..., None].to(F32) * freqs                  # (..., S, half)
    return _rotate(x, ang[..., None, :])                        # (..., S, 1, half)


def mrope(x, positions3, sections: Tuple[int, int, int], theta: float = 1e4):
    """Qwen2-VL multimodal RoPE.  positions3: (3, ..., S) for (t, h, w);
    frequency slots are split into three sections, each rotated by its own
    positional stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(half, theta, x.device)
    # pick each frequency slot's positional stream (the reference's one-hot
    # mix of integer positions, which is exact), by slices: no index tensor
    # is copied to the device, so a CUDA graph can capture it
    pos_t = torch.movedim(positions3, 0, -1).to(F32)            # (..., S, 3)
    pos_mix = torch.cat([pos_t[..., i:i + 1].expand(pos_t.shape[:-1] + (n,))
                         for i, n in enumerate(sections)], dim=-1)   # (..., S, half)
    return _rotate(x, (pos_mix * freqs)[..., None, :])


def sinusoidal_positions(S: int, d: int, offset=0, device=None):
    pos = torch.arange(S, dtype=F32, device=device) + offset
    inv = 1e4 ** (-torch.arange(0, d, 2, dtype=F32, device=device) / d)
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (S, d)


# -------------------------------------------------------------- attention
def attention_params(c: Creator, cfg) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": linear_params(c, d, cfg.num_heads * hd, cfg.qkv_bias),
        "wk": linear_params(c, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wv": linear_params(c, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wo": linear_params(c, cfg.num_heads * hd, d, False),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def online_attention(
    q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
    sliding_window: int = 0, q_offset: int = 0,
):
    """Online-softmax (flash-style) attention over q chunks and kv chunks.

    q: (B, Sq, H, hd); k/v: (B, Sk, Hkv, hd).  Never materializes the full
    (Sq, Sk) score matrix.  GQA by a grouped einsum over (kv-head, group):
    K/V stay unexpanded.  Masked scores are ``NEG_INF``, not -inf, so a
    chunk masked whole adds weight that the next unmasked chunk's
    rescaling wipes, exactly as in the reference.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    cq = min(q_chunk, Sq)
    ck = min(kv_chunk, Sk)
    while Sq % cq:
        cq -= 1
    while Sk % ck:
        ck -= 1
    nq, nk = Sq // cq, Sk // ck
    dev = q.device
    q_ = q.reshape(B, nq, cq, Hkv, G, hd)
    k_ = k.reshape(B, nk, ck, Hkv, hd)
    v_ = v.reshape(B, nk, ck, Hkv, hd)
    outs = []
    for iq in range(nq):
        qc = q_[:, iq].to(F32) * scale                          # (B, cq, Hkv, G, hd)
        qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=F32, device=dev)
        denom = torch.zeros((B, Hkv, G, cq), dtype=F32, device=dev)
        acc = torch.zeros((B, Hkv, G, cq, hd), dtype=F32, device=dev)
        for ik in range(nk):
            kc = k_[:, ik].to(F32)                              # (B, ck, Hkv, hd)
            vc = v_[:, ik].to(F32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc)
            kpos = ik * ck + torch.arange(ck, device=dev)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if sliding_window:
                mask &= qpos[:, None] - kpos[None, :] < sliding_window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            denom = denom * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        out = acc / denom[..., None]                            # (B, Hkv, G, cq, hd)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))    # (B, cq, Hkv, G, hd)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, length, k_scale=None, v_scale=None):
    """The reference's ``decode_attention_jnp``.  q: (B, H, hd) one token;
    caches (B, S, Hkv, hd); length () or (B,).

    Grouped einsum (no KV expansion).  With ``k_scale/v_scale`` (B, S, Hkv)
    the caches are int8 and the scales fold into the scores and the
    weights AFTER the int8 reads.
    """
    B, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, Hkv, G, hd).to(F32) * scale
    # q's head dim on the cache's 'model' sharding, where the reference pins it
    qg = _constrain_last_dim_model(qg)
    kc = k_cache.to(F32)
    vc = v_cache.to(F32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc)                 # (B, Hkv, G, S)
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, :]
    length = torch.as_tensor(length, device=q.device)
    valid = torch.arange(S, device=q.device)[None, None, None, :] < length.reshape(-1, 1, 1, 1)
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgk,bkhd->bhgd", p, vc) / torch.sum(
        torch.exp(s - m), dim=-1
    )[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _constrain_last_dim_model(x):
    """Shard the last dim over 'model' when a mesh is active and divides."""
    from ..distributed.sharding import axis_size, axis_sizes, constrain, current_mesh

    mesh = current_mesh()
    if mesh is None or "model" not in axis_sizes(mesh):
        return x
    if x.shape[-1] % axis_size(mesh, "model"):
        return x
    return constrain(x, (None,) * (x.ndim - 1) + ("model",))


def _constrain_rows_model(x):
    """Shard a (rows, d) expert-dispatch buffer's rows over 'model' (EP).
    No-op outside a mesh context."""
    from ..distributed.sharding import axis_size, axis_sizes, constrain, current_mesh

    mesh = current_mesh()
    if mesh is None or "model" not in axis_sizes(mesh):
        return x
    if x.shape[0] % axis_size(mesh, "model"):
        return x
    return constrain(x, ("model", None))


def quantize_kv_int8(x):
    """x: (B, Hkv, hd) -> (int8 values, (B, Hkv) f32 scales).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.to(F32)
    amax = torch.amax(torch.abs(x32), dim=-1) + 1e-8
    s = amax / 127.0
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


# ------------------------------------------------------------------- MLPs
def swiglu_params(c: Creator, d: int, ff: int) -> Params:
    return {
        "wi": linear_params(c, d, ff),
        "wg": linear_params(c, d, ff),
        "wo": linear_params(c, ff, d),
    }


def swiglu(p: Params, x):
    return linear(p["wo"], F.silu(linear(p["wg"], x)) * linear(p["wi"], x))


def gelu_mlp_params(c: Creator, d: int, ff: int) -> Params:
    return {
        "wi": linear_params(c, d, ff, bias=True),
        "wo": linear_params(c, ff, d, bias=True),
    }


def gelu_mlp(p: Params, x):
    # jax.nn.gelu's default is the tanh approximation
    return linear(p["wo"], F.gelu(linear(p["wi"], x), approximate="tanh"))


# -------------------------------------------------------------------- MoE
def moe_params(c: Creator, cfg) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    Ep = E + cfg.moe_pad_experts      # dummy experts receive no tokens
    return {
        "router": c.param((d, E), "fan_in", dtype=F32),
        "wi": c.param((Ep, d, ff), "fan_in"),
        "wg": c.param((Ep, d, ff), "fan_in"),
        "wo": c.param((Ep, ff, d), "fan_in"),
    }


def _router(p: Params, x, cfg):
    logits = einsum("...d,de->...e", x.to(F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k returns ties lowest index first; a stable descending
    # sort does the same, where torch.topk promises no order among ties
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., : cfg.moe_top_k], idx[..., : cfg.moe_top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, idx                                               # (..., k)


def moe_dense(p: Params, x, cfg):
    """Smoke-test mode: every expert computes every token, masked combine.
    Exact (no capacity drops); O(E) compute."""
    B, S, d = x.shape
    Ep = cfg.moe_experts + cfg.moe_pad_experts
    w, idx = _router(p, x, cfg)                                 # (B, S, k)
    # one batched product per weight with the experts as its batch: the
    # tokens broadcast over them, and no weight is permuted or copied
    dt = torch.promote_types(x.dtype, p["wg"].dtype)
    xe = x.reshape(1, B * S, d).to(dt).expand(Ep, B * S, d)
    h = torch.bmm(xe, p["wg"].to(dt))                          # (Ep, B*S, ff)
    hi = torch.bmm(xe, p["wi"].to(dt))
    y = torch.bmm(F.silu(h) * hi, p["wo"].to(dt))              # (Ep, B*S, d)
    onehot = F.one_hot(idx, Ep).to(F32)                         # (B,S,k,Ep)
    mix = torch.einsum("bske,bsk->bse", onehot, w).reshape(B * S, Ep)
    out = torch.einsum("etd,te->td", y.to(F32), mix)
    return out.reshape(B, S, d).to(x.dtype)


def moe_capacity(cfg, S: int) -> int:
    """Slots per expert and group: ceil(factor·k·S/E), rounded up to a
    multiple of 64 and at least 64."""
    C = int(math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * S / cfg.moe_experts))
    return max(64, (C + 63) // 64 * 64)


def moe_scatter(p: Params, x, cfg):
    """GROUP-WISE capacity dispatch: each sequence is its own GShard group —
    routing positions, the (E, C, d) expert batches and the combine are
    computed per sequence.  Over-capacity tokens within a group drop.
    """
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    Ep = E + cfg.moe_pad_experts
    dev = x.device
    w, idx = _router(p, x, cfg)                                 # (B, S, k)
    C = moe_capacity(cfg, S)

    flat_e = idx.reshape(B, S * k)                              # (B, S*k)
    # each route's place in its expert's queue: a running count per expert,
    # scanned along the innermost axis of an (B, E, S*k) one-hot
    onehot = (flat_e[:, None, :] == torch.arange(E, device=dev)[None, :, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
    if C < 32767:
        # the reference counts in int16: wrap as it does before comparing with C
        pos = pos.to(torch.int16)
    slot = torch.gather(pos, 1, flat_e[:, None, :])[:, 0].to(torch.int64)
    keep = slot < C
    token_of = torch.arange(S, device=dev).repeat_interleave(k)
    # dropped tokens all write row Ep*C of each group's Ep*C+64 rows, which
    # the combine never reads
    flat_slot = torch.where(keep, flat_e * C + slot, Ep * C)
    group = torch.arange(B, device=dev)[:, None]
    gathered = torch.zeros((B * (Ep * C + 64), d), dtype=x.dtype, device=dev)
    gathered.index_copy_(0, (group * (Ep * C + 64) + flat_slot).reshape(-1),
                         torch.index_select(x, 1, token_of).reshape(-1, d))
    ein = gathered.reshape(B, Ep * C + 64, d)[:, : Ep * C].reshape(B, Ep, C, d)
    h = einsum("gecd,edf->gecf", ein, p["wg"])
    hi = einsum("gecd,edf->gecf", ein, p["wi"])
    out_e = einsum("gecf,efd->gecd", F.silu(h) * hi, p["wo"])

    rows = out_e.reshape(B * Ep * C, d)
    read = (group * (Ep * C) + torch.clamp(flat_slot, max=Ep * C - 1)).reshape(-1)
    picked = torch.where(
        keep[..., None], torch.index_select(rows, 0, read).reshape(B, S * k, d),
        torch.zeros((), dtype=rows.dtype, device=dev),
    )                                                           # (B, S*k, d)
    # the combine weights round to the rows' dtype; the sum runs in f32
    wk = w.to(picked.dtype).to(F32)
    yt = torch.einsum("bskd,bsk->bsd", picked.reshape(B, S, k, d).to(F32), wk)
    return yt.to(x.dtype)


def moe(p: Params, x, cfg):
    if cfg.moe_impl == "dense":
        return moe_dense(p, x, cfg)
    return moe_scatter(p, x, cfg)


# -------------------------------------------------------------- embedding
def embedding_params(c: Creator, cfg) -> Params:
    return {
        "tok": c.param((cfg.padded_vocab, cfg.d_model), "normal"),
        "unembed": c.param((cfg.d_model, cfg.padded_vocab), "fan_in"),
    }


def embed(p: Params, tokens):
    """Rows of the table; ``F.embedding``, whose backward (a dense scatter
    of the rows' gradients) a CUDA graph can capture."""
    return F.embedding(tokens.long(), p["tok"])


def unembed(p: Params, x):
    return einsum("...d,dv->...v", x, p["unembed"])
