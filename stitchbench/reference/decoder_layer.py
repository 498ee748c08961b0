"""Plain PyTorch reference of a stack of pre-norm decoder layers, in float32.

It imports nothing of the program under test and takes nothing the program
made: only the weights and inputs the benchmark drew from the seed.  It
follows the published layer equations directly (RoPE by slicing the two
halves, GQA by ``repeat_interleave``, the causal mask by ``torch.triu``,
softmax by ``torch.softmax``, SiLU by ``x * sigmoid(x)``), one sequence at
a time so that the scores of a long prompt fit beside the weights.  Inputs
held in a narrower type are widened to float32 first.

``precision`` says how it computes: ``"exact"`` in float32 with TF32 off;
``"tf32"`` with TF32 on (the control of a float32 configuration);
``"fp8"`` with both operands of every product and the residual stream
after each sublayer rounded to float8 e4m3 under a scale per tensor (the
control of a bfloat16 configuration).
"""
from __future__ import annotations

import contextlib

import torch

#: the largest finite float8 e4m3 value: a tensor's scale maps its largest
#: magnitude onto it
FP8_MAX = 448.0


def rope_tables(theta: float, seq: int, head_dim: int, device=None):
    """cos and sin of positions 0..seq-1, (seq, head_dim) float32, each
    frequency repeated over the two halves; computed in float64 so that
    both sides read the same bits."""
    inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


@contextlib.contextmanager
def tf32(enabled: bool):
    """Both float32 matmul switches set to ``enabled`` inside the block."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor,
    back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _rotate_half(t):
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def _rms(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * g


def layer(cfg: dict, shape: dict, x, w: dict, cos, sin, mm, rnd):
    """One decoder layer over one sequence ``x`` of shape (seq, d_model):
    the attention sublayer, then the gated MLP sublayer where the
    configuration has one.  ``mm`` computes every product, ``rnd`` rounds
    the residual stream after each sublayer."""
    heads, kv, hd = shape["heads"], shape["kv_heads"], shape["head_dim"]
    seq = x.shape[0]
    h = _rms(x, w["g"], cfg["rms_norm_eps"])
    q = mm(h, w["wq"]).view(seq, heads, hd).transpose(0, 1)
    k = mm(h, w["wk"]).view(seq, kv, hd).transpose(0, 1)
    v = mm(h, w["wv"]).view(seq, kv, hd).transpose(0, 1)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    k = k.repeat_interleave(heads // kv, dim=0)
    v = v.repeat_interleave(heads // kv, dim=0)
    s = mm(q, k.transpose(-1, -2)) * cfg["attn_scale"]
    future = torch.triu(torch.ones(seq, seq, dtype=torch.bool, device=x.device), diagonal=1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    o = mm(p, v).transpose(0, 1).reshape(seq, heads * hd)
    x = rnd(x + mm(o, w["wo"]) * cfg["residual_scale"])
    if "wg" not in w:
        return x
    h = _rms(x, w["g2"], cfg["rms_norm_eps"])
    a = mm(h, w["wg"])
    return rnd(x + mm(a * torch.sigmoid(a) * mm(h, w["wu"]), w["wd"]) * cfg["residual_scale"])


def forward(cfg: dict, shape: dict, seq: int, layers, x, cos, sin, precision: str = "exact"):
    """The stack over ``x`` of shape (batch * seq, d_model), a sequence at a
    time, layer after layer, in float32; returns float32."""
    if precision == "fp8":
        def mm(a, b):
            return torch.matmul(fp8(a), fp8(b))
        rnd = fp8
    else:
        mm, rnd = torch.matmul, (lambda t: t)
    out, cos, sin = [], cos.float(), sin.float()
    with tf32(precision == "tf32"), torch.no_grad():
        for xs in x.split(seq):
            xs = xs.float()
            for w in layers:
                xs = layer(cfg, shape, xs, {k: t.float() for k, t in w.items()}, cos, sin, mm,
                           rnd)
            out.append(xs)
    return torch.cat(out, dim=0)
