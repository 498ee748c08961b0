"""Plain PyTorch reference of a hybrid stack of Mamba-2 and attention
layers (granite-4.0-h), in float32.

It imports nothing of the program under test and takes nothing the program
made: only the weights and inputs the benchmark drew from the seed.  A
layer whose weights hold ``w_in`` is a Mamba-2 layer; any other is
``decoder_layer``'s attention layer (``reference/decoder_layer.py``), which
with tables of cos 1 and sin 0 applies no rotation.  Each layer then runs
the gated SiLU MLP.  A sequence at a time, layer after layer.

The Mamba-2 mixer follows the published equations step by step, not the
chunked algorithm the program runs:

* ``[z, xBC, dt] = h W_in``;
* ``xBC = silu(causal depthwise conv1d(xBC) + b)``: each channel's output
  at ``t`` is the sum of ``w[c, k] * xBC[t - (K - 1) + k, c]`` over the
  taps that reach back to ``t >= 0``; ``xBC`` splits into x (heads x
  head_dim), B and C (d_state each);
* ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
* the state runs the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗
  B_t`` one position after another, vectorised over the heads, and ``y_t =
  h_t C_t + D x_t``;
* ``y = rms(y * silu(z), g_norm)`` over the inner width, then ``y W_out``.

``precision`` is ``reference/decoder_layer.py``'s: ``"exact"`` in float32
with TF32 off, ``"tf32"`` with TF32 on (the control of a float32
configuration), ``"fp8"`` with the operands of every projection and the
residual stream after each sublayer rounded to float8 e4m3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from stitchbench.reference import decoder_layer


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * g


def recurrence(x, dt, a, b, c):
    """The state space one position after another, vectorised over the
    heads: ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t ⊗ b_t`` from ``h = 0``,
    and ``y_t = h_t c_t``.  x (seq, heads, head_dim), dt (seq, heads), a
    (heads,), b and c (seq, d_state); returns y like x."""
    seq, heads, hd = x.shape
    state = x.new_zeros(heads, hd, b.shape[1])
    y = torch.empty_like(x)
    decay = torch.exp(dt * a)[:, :, None, None]
    dtx = (x * dt[:, :, None])[..., None]
    # each step's operands as views made once, so the loop issues kernels only
    for decay_t, dtx_t, b_t, c_t, y_t in zip(decay.unbind(0), dtx.unbind(0), b.unbind(0),
                                              c.unbind(0), y.unbind(0)):
        state.mul_(decay_t).addcmul_(dtx_t, b_t)
        torch.matmul(state, c_t, out=y_t)
    return y


def mamba_mixer(cfg: dict, h, w: dict, mm):
    """The Mamba-2 mixer over one sequence ``h`` of shape (seq, d_model),
    its state by the sequential recurrence; ``mm`` computes the
    projections."""
    heads, hd, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner, taps = heads * hd, cfg["mamba_d_conv"]
    seq = h.shape[0]
    zxbcdt = mm(h, w["w_in"])
    z, xbc, dt = zxbcdt[:, :inner], zxbcdt[:, inner:-heads], zxbcdt[:, -heads:]
    past = torch.cat([xbc.new_zeros(taps - 1, xbc.shape[1]), xbc])
    conv = w["conv_b"] + sum(past[k:k + seq] * w["conv_w"][:, 0, k] for k in range(taps))
    xbc = conv * torch.sigmoid(conv)
    x, b, c = xbc[:, :inner].reshape(seq, heads, hd), xbc[:, inner:inner + n], xbc[:, inner + n:]
    dt = F.softplus(dt + w["dt_bias"])
    y = recurrence(x, dt, -torch.exp(w["A_log"]), b, c) + x * w["D"][:, None]
    y = y.reshape(seq, inner) * F.silu(z)
    return mm(_rms(y, w["g_norm"], cfg["rms_norm_eps"]), w["w_out"])


def layer(cfg: dict, shape: dict, x, w: dict, cos, sin, mm, rnd):
    """One layer over one sequence ``x`` of shape (seq, d_model)."""
    if "w_in" not in w:
        return decoder_layer.layer(cfg, shape, x, w, cos, sin, mm, rnd)
    eps, res = cfg["rms_norm_eps"], cfg["residual_scale"]
    x = rnd(x + mamba_mixer(cfg, _rms(x, w["g"], eps), w, mm) * res)
    h = _rms(x, w["g2"], eps)
    a = mm(h, w["wg"])
    return rnd(x + mm(a * torch.sigmoid(a) * mm(h, w["wu"]), w["wd"]) * res)


def forward(cfg: dict, shape: dict, seq: int, layers, x, cos, sin, precision: str = "exact"):
    """The stack over ``x`` of shape (batch * seq, d_model), a sequence at a
    time, layer after layer, in float32; returns float32."""
    if precision == "fp8":
        def mm(a, b):
            return torch.matmul(decoder_layer.fp8(a), decoder_layer.fp8(b))
        rnd = decoder_layer.fp8
    else:
        mm, rnd = torch.matmul, (lambda t: t)
    out, cos, sin = [], cos.float(), sin.float()
    with decoder_layer.tf32(precision == "tf32"), torch.no_grad():
        for xs in x.split(seq):
            xs = xs.float()
            for w in layers:
                xs = layer(cfg, shape, xs, {k: t.float() for k, t in w.items()}, cos, sin, mm,
                           rnd)
            out.append(xs)
    return torch.cat(out, dim=0)
