"""Plain PyTorch reference of a hybrid stack of Gated DeltaNet and
full-attention layers (Olmo-Hybrid), in float32.

It imports nothing of the program under test and takes nothing the program
made: only the weights and inputs the benchmark drew from the seed.  A
layer whose weights hold ``gq`` is a full-attention layer; any other is a
Gated DeltaNet layer.  Both are Olmo's: the mixer, an RMSNorm of its
output, the residual add; then the gated SiLU MLP, an RMSNorm of its
output, the residual add.  A sequence at a time, layer after layer.

The full-attention layer: q and k RMS-normed over their whole projections
(QK-norm), multi-head causal attention with no positional encoding,
softmax by ``torch.softmax``, a few heads at a time so that the scores of
a long prompt fit beside the weights.

The Gated DeltaNet mixer follows the delta rule one position at a time
(flash-linear-attention's ``naive_recurrent_gated_delta_rule``), not the
chunked algorithm the program runs:

* q, k, v = ``silu(causal depthwise conv1d(x W))`` each, with no bias;
  q and k L2-normed per head, q scaled by ``d_k^-1/2``;
* ``beta = 2 sigmoid(x W_b)``, ``alpha = exp(-exp(A_log) softplus(x W_a +
  dt_bias))``;
* per head, from ``S = 0`` (d_k x d_v): ``S = alpha_t S``, ``u = beta_t (v_t
  - Sᵀ k_t)``, ``S = S + k_t uᵀ``, ``o_t = Sᵀ q_t``: the state of
  ``S_t = alpha_t S_{t-1} (I - beta_t k_t k_tᵀ) + beta_t v_t k_tᵀ``
  transposed;
* ``o = rms(o, g_norm) * silu(x W_gate)`` per head, then ``o W_o``.

``precision`` is ``reference/decoder_layer.py``'s: ``"exact"`` in float32
with TF32 off, ``"tf32"`` with TF32 on (the control of a float32
configuration), ``"fp8"`` with the operands of every projection and the
residual stream after each sublayer rounded to float8 e4m3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from stitchbench.reference import decoder_layer

#: heads of the full-attention layer whose scores are held at once
HEADS_AT_ONCE = 6
#: ``l2norm``'s epsilon in flash-linear-attention
L2_EPS = 1e-6


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * g


def _silu(t):
    return t * torch.sigmoid(t)


def short_conv(t, w):
    """Causal depthwise conv1d with no bias, then SiLU: t (seq, channels),
    w (channels, 1, taps); each channel's output at ``i`` sums ``w[c, j] *
    t[i - (taps - 1) + j, c]`` over the taps that reach back to 0."""
    taps, seq = w.shape[-1], t.shape[0]
    past = torch.cat([t.new_zeros(taps - 1, t.shape[1]), t])
    return _silu(sum(past[j:j + seq] * w[:, 0, j] for j in range(taps)))


def recurrence(q, k, v, alpha, beta):
    """The gated delta rule one position after another, vectorised over the
    heads.  q, k (seq, heads, d_k), already normed and scaled; v (seq,
    heads, d_v); alpha, beta (seq, heads).  Returns o like v."""
    seq, heads, dk = k.shape
    state = k.new_zeros(heads, dk, v.shape[-1])
    o = torch.empty_like(v)
    # each step's operands as views made once, so the loop issues kernels only
    for q_t, k_t, v_t, a_t, b_t, o_t in zip(q.unbind(0), k.unbind(0), v.unbind(0),
                                            alpha.unbind(0), beta.unbind(0), o.unbind(0)):
        state.mul_(a_t[:, None, None])
        u = (v_t - torch.matmul(k_t[:, None, :], state)[:, 0]) * b_t[:, None]
        state.add_(k_t[:, :, None] * u[:, None, :])
        torch.matmul(q_t[:, None, :], state, out=o_t[:, None, :])
    return o


def deltanet_mixer(cfg: dict, x, w: dict, mm):
    """The Gated DeltaNet mixer over one sequence ``x`` of shape (seq,
    d_model); ``mm`` computes the projections."""
    heads, dk, dv = (cfg["linear_num_value_heads"], cfg["linear_key_head_dim"],
                     cfg["linear_value_head_dim"])
    seq = x.shape[0]
    q = short_conv(mm(x, w["wq"]), w["conv_q"]).reshape(seq, heads, dk)
    k = short_conv(mm(x, w["wk"]), w["conv_k"]).reshape(seq, heads, dk)
    v = short_conv(mm(x, w["wv"]), w["conv_v"]).reshape(seq, heads, dv)
    q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + L2_EPS) * dk ** -0.5
    k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + L2_EPS)
    beta = 2.0 * torch.sigmoid(mm(x, w["wb"]))
    alpha = torch.exp(-torch.exp(w["A_log"]) * F.softplus(mm(x, w["wa"]) + w["dt_bias"]))
    o = recurrence(q, k, v, alpha, beta)
    o = _rms(o, w["g_norm"], cfg["rms_norm_eps"]) * _silu(mm(x, w["w_gate"]).reshape(seq, heads, dv))
    return mm(o.reshape(seq, heads * dv), w["wo"])


def attention(cfg: dict, x, w: dict, mm):
    """The full-attention mixer over one sequence: QK-norm, no positional
    encoding, causal softmax attention a few heads at a time."""
    heads, hd, eps = cfg["num_attention_heads"], cfg["head_dim"], cfg["rms_norm_eps"]
    kv = cfg["num_key_value_heads"]
    seq = x.shape[0]
    q = _rms(mm(x, w["wq"]), w["gq"], eps).view(seq, heads, hd).transpose(0, 1)
    k = _rms(mm(x, w["wk"]), w["gk"], eps).view(seq, kv, hd).transpose(0, 1)
    v = mm(x, w["wv"]).view(seq, kv, hd).transpose(0, 1)
    k = k.repeat_interleave(heads // kv, dim=0)
    v = v.repeat_interleave(heads // kv, dim=0)
    future = torch.triu(torch.ones(seq, seq, dtype=torch.bool, device=x.device), diagonal=1)
    o = []
    for h in range(0, heads, HEADS_AT_ONCE):
        s = mm(q[h:h + HEADS_AT_ONCE], k[h:h + HEADS_AT_ONCE].transpose(-1, -2)) * hd ** -0.5
        o.append(mm(torch.softmax(s.masked_fill(future, float("-inf")), dim=-1),
                    v[h:h + HEADS_AT_ONCE]))
        del s
    return mm(torch.cat(o).transpose(0, 1).reshape(seq, heads * hd), w["wo"])


def layer(cfg: dict, x, w: dict, mm, rnd):
    """One layer over one sequence ``x`` of shape (seq, d_model)."""
    eps = cfg["rms_norm_eps"]
    mixer = attention if "gq" in w else deltanet_mixer
    x = rnd(x + _rms(mixer(cfg, x, w, mm), w["g"], eps))
    a = mm(x, w["wg"])
    return rnd(x + _rms(mm(_silu(a) * mm(x, w["wu"]), w["wd"]), w["g2"], eps))


def forward(cfg: dict, shape: dict, seq: int, layers, x, cos, sin, precision: str = "exact"):
    """The stack over ``x`` of shape (batch * seq, d_model), a sequence at a
    time, layer after layer, in float32; returns float32.  ``cos`` and
    ``sin`` (the benchmark's tables of no rotation) are not read."""
    if precision == "fp8":
        def mm(a, b):
            return torch.matmul(decoder_layer.fp8(a), decoder_layer.fp8(b))
        rnd = decoder_layer.fp8
    else:
        mm, rnd = torch.matmul, (lambda t: t)
    out = []
    with decoder_layer.tf32(precision == "tf32"), torch.no_grad():
        for xs in x.split(seq):
            xs = xs.float()
            for w in layers:
                xs = layer(cfg, xs, {k: t.float() for k, t in w.items()}, mm, rnd)
            out.append(xs)
    return torch.cat(out, dim=0)
