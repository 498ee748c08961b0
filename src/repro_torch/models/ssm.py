"""Mamba2 — SSD (state-space duality) block, arXiv:2405.21060.

Training/prefill uses the chunked dual form (quadratic attention-like
intra-chunk einsums + linear inter-chunk recurrence); decode is the
O(1)-per-token recurrent state update.  Function for function the
reference's ``repro/models/ssm.py``, in plain torch ops.

ngroups=1 (B/C shared across heads), depthwise causal conv width 4 on
(x, B, C), gated RMSNorm output — the standard minimal-Mamba2 structure.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import F32, einsum, linear, linear_params, rmsnorm
from .module import Creator, Params


def ssm_dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, num_heads, head_dim P, state N)."""
    if cfg.family == "hybrid":
        d_in = cfg.num_heads * cfg.ssm_head_dim        # parallel-head width
    else:
        d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    return d_in, H, P, cfg.ssm_state


def mamba2_params(c: Creator, cfg) -> Params:
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "in_proj": linear_params(c, d, 2 * d_in + 2 * N + H),
        "conv_w": c.param((cfg.ssm_conv_width, conv_ch), "normal", scale=0.1),
        "conv_b": c.param((conv_ch,), "zeros", dtype=F32),
        "A_log": c.param((H,), "zeros", dtype=F32),
        "D": c.param((H,), "ones", dtype=F32),
        "dt_bias": c.param((H,), "zeros", dtype=F32),
        "norm": {"gamma": c.param((d_in,), "ones", dtype=F32)},
        "out_proj": linear_params(c, d_in, d),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, C), w (K, C).  Shifted sums in f32,
    as the reference adds them (not ``conv1d``, whose cuDNN path may run
    in TF32)."""
    K = w.shape[0]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(K):
        out = out + pads[:, i: i + x.shape[1]].to(F32) * w[i]
    return (out + b).to(x.dtype)


def _segsum(dA):
    """dA: (..., L, H) -> cumulative decay matrix T[i, j] = sum_{j<k<=i} dA_k
    (lower-triangular; -inf above the diagonal)."""
    L = dA.shape[-2]
    cs = torch.cumsum(dA, dim=-2)                              # (..., L, H)
    diff = cs[..., :, None, :] - cs[..., None, :, :]           # (..., L, L, H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.where(mask[..., None], diff, float("-inf"))


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_zxbcdt(zxbcdt, d_in: int, N: int):
    H = zxbcdt.shape[-1] - 2 * d_in - 2 * N
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def ssd_chunked(x, dt, A_log, Bm, Cm, D, chunk: int):
    """The SSD dual-form scan.

    x  : (B, S, H, P)   dt : (B, S, H)  (post-softplus)
    Bm : (B, S, N)      Cm : (B, S, N)
    returns y (B, S, H, P) and final state (B, H, P, N).
    """
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    nc = S // c
    A = -torch.exp(A_log.to(F32))                              # (H,)
    dA = dt * A                                                # (B, S, H)
    xc = x.reshape(b, nc, c, H, P).to(F32)
    dtc = dt.reshape(b, nc, c, H)
    dAc = dA.reshape(b, nc, c, H)
    Bc = Bm.reshape(b, nc, c, N).to(F32)
    Cc = Cm.reshape(b, nc, c, N).to(F32)

    # intra-chunk (quadratic within chunk, like masked attention)
    Lmat = torch.exp(_segsum(dAc))                             # (b,nc,c,c,H)
    scores = torch.einsum("bzln,bzsn->bzls", Cc, Bc)           # (b,nc,c,c)
    M = scores[..., None] * Lmat                               # (b,nc,l,s,H)
    y_diag = torch.einsum("bzlsh,bzsh,bzshp->bzlhp", M, dtc, xc)

    # chunk-final states
    cs = torch.cumsum(dAc, dim=2)                              # (b,nc,c,H)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)            # (b,nc,c,H)
    states = torch.einsum("bzsn,bzsh,bzshp->bzhpn", Bc, decay_to_end * dtc, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (b,nc,H)
    s_prev = torch.zeros((b, H, P, N), dtype=F32, device=x.device)
    prevs = []
    for z in range(nc):
        prevs.append(s_prev)
        s_prev = states[:, z] + chunk_decay[:, z][..., None, None] * s_prev
    final = s_prev
    prev_states = torch.stack(prevs, dim=1)                    # (b,nc,H,P,N)

    decay_from_start = torch.exp(cs)                           # (b,nc,c,H)
    y_off = torch.einsum("bzln,bzhpn,bzlh->bzlhp", Cc, prev_states, decay_from_start)
    y = (y_diag + y_off).reshape(b, S, H, P)
    y = y + D[None, None, :, None] * x.to(F32)
    return y.to(x.dtype), final


def mamba2_forward(p: Params, x, cfg, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d).  Full-sequence (train / prefill)."""
    B, S, d = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    zxbcdt = linear(p["in_proj"], x)
    z, xs, Bm, Cm, dt = _split_zxbcdt(zxbcdt, d_in, N)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]).to(F32))
    xs, Bm, Cm = (
        conv_out[..., :d_in],
        conv_out[..., d_in: d_in + N],
        conv_out[..., d_in + N:],
    )
    dt = _softplus(dt.to(F32) + p["dt_bias"])
    xh = xs.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, p["A_log"], Bm, Cm, p["D"], chunk=128)
    y = y.reshape(B, S, d_in)
    y = rmsnorm(p["norm"], (y.to(F32) * F.silu(z.to(F32))).to(x.dtype), cfg.norm_eps)
    out = linear(p["out_proj"], y)
    if return_state:
        conv_tail = conv_in[:, -(cfg.ssm_conv_width - 1):, :]
        return out, {"ssm": state, "conv": conv_tail}
    return out


def mamba2_init_cache(cfg, batch: int, dtype=F32, device=None) -> Dict:
    d_in, H, P, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Params, x, cache: Dict, cfg, active=None):
    """x: (B, d) one token; O(1) state update.

    ``active``: optional (B,) bool — inactive rows keep their old state
    (continuous-batching write mask).  Returns (out, new cache) as the
    reference does; the caller writes the new cache where it keeps it."""
    B, d = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    zxbcdt = linear(p["in_proj"], x)
    z, xs, Bm, Cm, dt = _split_zxbcdt(zxbcdt, d_in, N)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, C)
    wdt = torch.promote_types(cache["conv"].dtype, conv_in.dtype)
    window = torch.cat([cache["conv"].to(wdt), conv_in[:, None, :].to(wdt)], dim=1)
    conv_out = einsum("bkc,kc->bc", window.to(F32), p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_in]
    Bm = conv_out[..., d_in: d_in + N]
    Cm = conv_out[..., d_in + N:]
    dt = _softplus(dt.to(F32) + p["dt_bias"])                  # (B, H)
    A = -torch.exp(p["A_log"].to(F32))
    dA = torch.exp(dt * A)                                     # (B, H)
    xh = xs.reshape(B, H, P)
    state = cache["ssm"] * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bm
    )
    y = torch.einsum("bhpn,bn->bhp", state, Cm) + p["D"][None, :, None] * xh
    y = y.reshape(B, d_in)
    y = rmsnorm(p["norm"], (y * F.silu(z.to(F32))).to(x.dtype), cfg.norm_eps)
    out = linear(p["out_proj"], y)
    new_conv = window[:, 1:, :].to(cache["conv"].dtype)
    if active is not None:
        sel = active.reshape(B, *([1] * (state.ndim - 1)))
        state = torch.where(sel, state, cache["ssm"])
        selc = active.reshape(B, *([1] * (new_conv.ndim - 1)))
        new_conv = torch.where(selc, new_conv, cache["conv"])
    return out, {"ssm": state, "conv": new_conv}
