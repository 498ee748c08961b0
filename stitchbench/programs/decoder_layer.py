"""A pre-norm decoder layer, as a user hands it to ``repro_torch.stitch``,
and the stack of such layers that one request runs through.

The layer is the attention sublayer (RMSNorm, the q/k/v projections, RoPE,
grouped-query attention under a causal mask, the output projection, the
scaled residual) and, where the configuration has a gated MLP
(``"mlp": "gated_silu"``), the MLP sublayer (RMSNorm, gate and up
projections, SiLU of the gate times the up, the down projection, the
residual), on ``x`` of shape (batch * seq, d_model).  It is compiled once;
a request calls it once a layer, each layer with weights of its own.

Where the configuration states a tensor-parallel deployment
(``tensor_parallel``: the chips that share each layer), this chip holds its
share of every layer: its query heads, its key/value heads and its slice
of the MLP's width.  The layer then adds this chip's partial sums to the
residual, without the exchange with the other chips.

Written in the ops the port's frontend lowers: RoPE's half rotation is a
reshape to (..., 2, head_dim / 2), a ``flip`` and a sign multiply (the
frontend lowers no slice), GQA is ``expand`` + ``reshape``, the mask is
``torch.where`` over ``torch.arange``, and softmax is max, exp and sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from stitchbench import work
from stitchbench.reference.decoder_layer import rope_tables

#: what one request needs, counted from the shapes
WORK = work.decoder_stack
#: the standard deviation of the projections' weights
WEIGHT_STD = 0.02
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shape(cfg: dict) -> dict:
    """The sizes this chip holds: every width as published, the heads and
    the MLP's width divided over the chips that share a layer."""
    tp = cfg.get("tensor_parallel", 1)
    s = {"d": cfg["hidden_size"], "head_dim": cfg["head_dim"],
         "heads": cfg["num_attention_heads"] // tp, "kv_heads": cfg["num_key_value_heads"] // tp,
         "layers": cfg["num_hidden_layers"], "dtype": cfg["dtype"]}
    if cfg.get("mlp") == "gated_silu":
        s["ff"] = cfg["intermediate_size"] // tp
    return s


def weight_shapes(s: dict) -> dict:
    """Each weight of one layer, by name, with its shape."""
    d, qd, kvd = s["d"], s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    out = {"g": (d,), "wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    if "ff" in s:
        out.update(g2=(d,), wg=(d, s["ff"]), wu=(d, s["ff"]), wd=(s["ff"], d))
    return out


def args(cfg: dict):
    """The layer's arguments after ``x``, in order."""
    return tuple(weight_shapes(shape(cfg))) + ("cos", "sin")


def build(cfg: dict, batch: int, seq: int):
    """The function the benchmark compiles: one layer, for one
    configuration's widths and one traffic mix's (batch, seq)."""
    s = shape(cfg)
    heads, kv, hd = s["heads"], s["kv_heads"], s["head_dim"]
    eps, attn_scale, res_scale = cfg["rms_norm_eps"], cfg["attn_scale"], cfg["residual_scale"]
    group, half = heads // kv, hd // 2

    def rope(t, n, cos, sin, sign):
        rot = (t.reshape(batch, n, seq, 2, half).flip(-2) * sign).reshape(batch, n, seq, hd)
        return t * cos + rot * sin

    def rms(x, g):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g

    def attention(x, g, wq, wk, wv, wo, cos, sin):
        h = rms(x, g)
        q = torch.matmul(h, wq).reshape(batch, seq, heads, hd).transpose(1, 2)
        k = torch.matmul(h, wk).reshape(batch, seq, kv, hd).transpose(1, 2)
        v = torch.matmul(h, wv).reshape(batch, seq, kv, hd).transpose(1, 2)
        sign = (torch.arange(2, device=x.device).to(x.dtype) * 2.0 - 1.0).reshape(2, 1)
        q = rope(q, heads, cos, sin, sign)
        k = rope(k, kv, cos, sin, sign)
        k = k.unsqueeze(2).expand(batch, kv, group, seq, hd).reshape(batch, heads, seq, hd)
        v = v.unsqueeze(2).expand(batch, kv, group, seq, hd).reshape(batch, heads, seq, hd)
        sc = torch.matmul(q, k.transpose(-1, -2)) * attn_scale
        pos = torch.arange(seq, device=x.device)
        sc = torch.where(pos.reshape(seq, 1) >= pos.reshape(1, seq), sc, float("-inf"))
        e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
        o = torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), v)
        o = o.transpose(1, 2).reshape(batch * seq, heads * hd)
        return x + torch.matmul(o, wo) * res_scale

    if "ff" not in s:
        return attention

    def decoder_layer(x, g, wq, wk, wv, wo, g2, wg, wu, wd, cos, sin):
        x = attention(x, g, wq, wk, wv, wo, cos, sin)
        h = rms(x, g2)
        m = F.silu(torch.matmul(h, wg)) * torch.matmul(h, wu)
        return x + torch.matmul(m, wd) * res_scale

    return decoder_layer


def make_inputs(cfg: dict, batch: int, seq: int, seed: int, distinct: int, device):
    """The weights of every layer and ``distinct`` inputs ``x`` of one run,
    drawn on ``device`` from ``seed`` in the configuration's type, one
    ``randn`` call a kind of weight: the projections N(0, 0.02), the gains
    1 + N(0, 0.02), each ``x`` N(0, 1).  Returns (the layers: a dict a
    layer of its weights by name; the RoPE tables (cos, sin) in float32;
    the list of ``x``)."""
    s = shape(cfg)
    dtype = DTYPES[s["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stacked = {}
    for name, shp in weight_shapes(s).items():
        t = torch.randn((s["layers"],) + shp, generator=gen, device=device, dtype=dtype)
        stacked[name] = t.mul_(WEIGHT_STD).add_(1.0) if name.startswith("g") else t.mul_(WEIGHT_STD)
    layers = [{name: t[i] for name, t in stacked.items()} for i in range(s["layers"])]
    cos, sin = rope_tables(cfg["rope_theta"], seq, s["head_dim"], device=device)
    n = batch * seq
    xs = torch.randn(distinct * n, s["d"], generator=gen, device=device, dtype=dtype)
    return layers, (cos.to(dtype), sin.to(dtype)), list(xs.split(n))
