"""A hybrid stack of Gated DeltaNet and full-attention layers, as a user
hands one layer to ``repro_torch.stitch``: Olmo-Hybrid's ``olmo_hybrid``
layers.

Every layer is Olmo's (OLMo 2): no norm before a sublayer, an RMSNorm of
the sublayer's output before its residual add, the mixer then the gated
SiLU MLP.  The mixer of a layer is the one its entry of ``layer_types``
names:

* ``full_attention``: multi-head causal attention with Olmo's QK-norm (an
  RMSNorm over the whole q and the whole k projection), written as
  ``decoder_layer``'s attention.  No positional encoding: the benchmark
  passes RoPE tables of cos 1 and sin 0, and ``t * 1 + rot * 0`` is ``t``;
* ``linear_attention``: the Gated DeltaNet mixer (Yang, Kautz and
  Hatamizadeh, arXiv:2412.06464) as flash-linear-attention's
  ``GatedDeltaNet`` layer writes it.  q, k and v each pass a causal
  depthwise ``conv1d`` of their own and SiLU; q and k are L2-normed per
  head; ``beta = 2 sigmoid(x W_b)`` (``allow_neg_eigval``) and ``log alpha
  = -exp(A_log) softplus(x W_a + dt_bias)``.  The delta rule runs as the
  published torch form of ``chunk_gated_delta_rule``: ``cumsum`` of
  ``log alpha`` within each chunk, the decay mask ``exp(g_i - g_j)`` under
  ``tril``, the UT transform's forward substitution as in-place writes
  into rows, ``u = T (beta v)`` and ``w = T (beta k e^g)``, then the
  loop over the chunks that carries the state, written with
  ``torch._higher_order_ops.scan``, which the frontend lowers to a loop
  of one compiled body (a Python loop, which ``make_fx`` unrolls, left
  the planner 8,785 instructions at 8k tokens, which it had not planned
  three minutes later; the ``scan`` leaves 1,381, planned in 13 s).  The
  output is RMS-normed per head, gated by ``silu(x W_gate)`` and
  projected by ``W_o``.

``build`` returns one function whose weights follow ``x``: the two kinds
of layer take different arguments, so ``stitch`` keeps a plan for each.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._higher_order_ops.scan import scan

from stitchbench import work
from stitchbench.programs import decoder_layer, hybrid_layer

WEIGHT_STD = decoder_layer.WEIGHT_STD
DTYPES = decoder_layer.DTYPES
LINEAR_WEIGHTS = ("wq", "wk", "wv", "conv_q", "conv_k", "conv_v", "wa", "wb", "A_log",
                  "dt_bias", "w_gate", "g_norm", "wo", "g", "wg", "wu", "wd", "g2")
FULL_WEIGHTS = ("wq", "wk", "wv", "gq", "gk", "wo", "g", "wg", "wu", "wd", "g2")
#: ``l2norm``'s epsilon in flash-linear-attention
L2_EPS = 1e-6


def held_types(cfg: dict) -> list:
    """The ``layer_types`` of the layers held, in order."""
    lo, hi = cfg["layers_held"]
    return list(cfg["layer_types"][lo:hi])


def shape(cfg: dict) -> dict:
    """The sizes this chip holds: every width as published."""
    if cfg["linear_num_key_heads"] != cfg["linear_num_value_heads"]:
        raise NotImplementedError("the program writes the delta rule for as many key as value heads")
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    lin, dk, dv = cfg["linear_num_value_heads"], cfg["linear_key_head_dim"], cfg["linear_value_head_dim"]
    return {"d": d, "heads": heads, "kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["head_dim"], "ff": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "dtype": cfg["dtype"],
            "lin_heads": lin, "dk": dk, "dv": dv, "key_dim": lin * dk, "value_dim": lin * dv,
            "d_conv": cfg["linear_conv_kernel_dim"], "chunk": cfg["chunk_size"]}


def weight_shapes(s: dict, kind: str) -> dict:
    """Each weight of one layer of ``kind``, by name, with its shape."""
    d, ff = s["d"], s["ff"]
    mlp = {"g": (d,), "wg": (d, ff), "wu": (d, ff), "wd": (ff, d), "g2": (d,)}
    if kind == "full_attention":
        qd, kvd = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
        return {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "gq": (qd,), "gk": (kvd,),
                "wo": (qd, d), **mlp}
    kd, vd, heads, taps = s["key_dim"], s["value_dim"], s["lin_heads"], s["d_conv"]
    return {"wq": (d, kd), "wk": (d, kd), "wv": (d, vd), "conv_q": (kd, 1, taps),
            "conv_k": (kd, 1, taps), "conv_v": (vd, 1, taps), "wa": (d, heads),
            "wb": (d, heads), "A_log": (heads,), "dt_bias": (heads,), "w_gate": (d, vd),
            "g_norm": (s["dv"],), "wo": (vd, d), **mlp}


def args(cfg: dict):
    """The first held layer's arguments after ``x``, in order."""
    kind = held_types(cfg)[0]
    return (LINEAR_WEIGHTS if kind == "linear_attention" else FULL_WEIGHTS) + ("cos", "sin")


def build(cfg: dict, batch: int, seq: int):
    """The function the benchmark compiles: one layer of either kind, told
    apart by its arguments, for one configuration's widths and one traffic
    mix's (batch, seq)."""
    s = shape(cfg)
    eps = cfg["rms_norm_eps"]
    heads, kv, hd = s["heads"], s["kv_heads"], s["head_dim"]
    lin, dk, dv, taps, c = s["lin_heads"], s["dk"], s["dv"], s["d_conv"], s["chunk"]
    if seq % c:
        raise ValueError(f"seq {seq} is no multiple of the delta rule's chunk {c}")
    chunks = seq // c
    group, half = heads // kv, hd // 2

    def rms(x, g):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g

    def mlp(x, wg, wu, wd, g2):
        m = F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
        return x + rms(torch.matmul(m, wd), g2)

    def rope(t, n, cos, sin, sign):
        rot = (t.reshape(batch, n, seq, 2, half).flip(-2) * sign).reshape(batch, n, seq, hd)
        return t * cos + rot * sin

    def full_layer(x, wq, wk, wv, gq, gk, wo, g, wg, wu, wd, g2, cos, sin):
        q = rms(torch.matmul(x, wq), gq).reshape(batch, seq, heads, hd).transpose(1, 2)
        k = rms(torch.matmul(x, wk), gk).reshape(batch, seq, kv, hd).transpose(1, 2)
        v = torch.matmul(x, wv).reshape(batch, seq, kv, hd).transpose(1, 2)
        sign = (torch.arange(2, device=x.device).to(x.dtype) * 2.0 - 1.0).reshape(2, 1)
        q = rope(q, heads, cos, sin, sign)
        k = rope(k, kv, cos, sin, sign)
        k = k.unsqueeze(2).expand(batch, kv, group, seq, hd).reshape(batch, heads, seq, hd)
        v = v.unsqueeze(2).expand(batch, kv, group, seq, hd).reshape(batch, heads, seq, hd)
        sc = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        pos = torch.arange(seq, device=x.device)
        sc = torch.where(pos.reshape(seq, 1) >= pos.reshape(1, seq), sc, float("-inf"))
        e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
        o = torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), v)
        o = o.transpose(1, 2).reshape(batch * seq, heads * hd)
        x = x + rms(torch.matmul(o, wo), g)
        return mlp(x, wg, wu, wd, g2)

    def short_conv(t, w):
        """flash-linear-attention's ``ShortConvolution``: a causal depthwise
        conv1d with no bias, then SiLU; t (batch * seq, channels)."""
        t = t.reshape(batch, seq, -1).transpose(1, 2)
        t = F.conv1d(t, w, padding=taps - 1, groups=t.shape[1])[..., :seq]
        return F.silu(t).transpose(1, 2)

    def l2norm(t):
        return t * torch.rsqrt((t * t).sum(dim=-1, keepdim=True) + L2_EPS)

    def chunk_gated_delta_rule(q, k, v, g, beta):
        """The published torch form of ``chunk_gated_delta_rule``: q, k
        (batch, seq, heads, dk), v (batch, seq, heads, dv), g = log alpha
        and beta (batch, seq, heads); returns (batch, seq, heads, dv)."""
        q, k = l2norm(q), l2norm(k)
        q, k, v, beta, g = (t.transpose(1, 2) for t in (q, k, v, beta, g))
        q = q * dk ** -0.5
        v_beta = v * beta.unsqueeze(-1)
        k_beta = k * beta.unsqueeze(-1)
        q, k, v, k_beta, v_beta = (t.reshape(batch, lin, chunks, c, t.shape[-1])
                                   for t in (q, k, v, k_beta, v_beta))
        g = g.reshape(batch, lin, chunks, c)
        mask = torch.triu(torch.ones(c, c, dtype=torch.bool, device=q.device), diagonal=0)
        # the decay within each chunk
        g = g.cumsum(dim=-1)
        decay_mask = (g.unsqueeze(-1) - g.unsqueeze(-2)).tril().exp().tril()
        attn = -(torch.matmul(k_beta, k.transpose(-1, -2)) * decay_mask).masked_fill(mask, 0)
        # the UT transform: (I + A)^-1 by forward substitution over the rows
        for i in range(1, c):
            row = attn[..., i, :i].clone()
            sub = attn[..., :i, :i].clone()
            attn[..., i, :i] = row + (row.unsqueeze(-1) * sub).sum(-2)
        attn = attn + torch.eye(c, dtype=attn.dtype, device=attn.device)
        value = torch.matmul(attn, v_beta)
        k_cumdecay = torch.matmul(attn, k_beta * g.exp().unsqueeze(-1))
        state = torch.zeros(batch, lin, dk, dv, dtype=v.dtype, device=v.device)

        def chunk_step(state, xs):
            """One chunk from the state the chunks before it left: its
            outputs and the state it leaves."""
            q_i, k_i, v_i, w_i, g_i, decay_i = xs
            mask = torch.triu(torch.ones(c, c, dtype=torch.bool, device=q_i.device), diagonal=1)
            attn = (torch.matmul(q_i, k_i.transpose(-1, -2)) * decay_i).masked_fill(mask, 0)
            v_new = v_i - torch.matmul(w_i, state)
            attn_inter = torch.matmul(q_i * g_i[..., None].exp(), state)
            out = attn_inter + torch.matmul(attn, v_new)
            g_last = g_i[..., -1, None]
            state = (state * g_last[..., None].exp()
                     + torch.matmul((k_i * (g_last - g_i).exp()[..., None]).transpose(-1, -2),
                                    v_new))
            return state, out

        # the chunks in turn: ``scan`` over the chunk dim of each operand
        _, out = scan(chunk_step, state, [t.movedim(2, 0) for t in
                                          (q, k, value, k_cumdecay, g, decay_mask)])
        out = out.movedim(0, 2)
        return out.reshape(batch, lin, seq, dv).transpose(1, 2)

    def mixer(x, wq, wk, wv, conv_q, conv_k, conv_v, wa, wb, a_log, dt_bias, w_gate, g_norm, wo):
        q = short_conv(torch.matmul(x, wq), conv_q).reshape(batch, seq, lin, dk)
        k = short_conv(torch.matmul(x, wk), conv_k).reshape(batch, seq, lin, dk)
        v = short_conv(torch.matmul(x, wv), conv_v).reshape(batch, seq, lin, dv)
        beta = torch.sigmoid(torch.matmul(x, wb)).reshape(batch, seq, lin) * 2.0
        g = -torch.exp(a_log) * F.softplus(torch.matmul(x, wa).reshape(batch, seq, lin) + dt_bias)
        o = chunk_gated_delta_rule(q, k, v, g, beta)
        gate = torch.matmul(x, w_gate).reshape(batch, seq, lin, dv)
        o = (rms(o, g_norm) * F.silu(gate)).reshape(batch * seq, lin * dv)
        return torch.matmul(o, wo)

    def linear_layer(x, wq, wk, wv, conv_q, conv_k, conv_v, wa, wb, a_log, dt_bias, w_gate,
                     g_norm, wo, g, wg, wu, wd, g2, cos, sin):
        x = x + rms(mixer(x, wq, wk, wv, conv_q, conv_k, conv_v, wa, wb, a_log, dt_bias,
                          w_gate, g_norm, wo), g)
        return mlp(x, wg, wu, wd, g2)

    def gated_deltanet_layer(x, *weights):
        if len(weights) == len(FULL_WEIGHTS) + 2:
            return full_layer(x, *weights)
        return linear_layer(x, *weights)

    return gated_deltanet_layer


def make_inputs(cfg: dict, batch: int, seq: int, seed: int, distinct: int, device):
    """The weights of every held layer and ``distinct`` inputs ``x`` of one
    run, drawn on ``device`` from ``seed`` in the configuration's type, one
    draw a kind of weight of each kind of layer: the projections N(0, 0.02),
    the gains 1 + N(0, 0.02), ``A_log`` and ``dt_bias`` as
    ``hybrid_layer`` draws them (Mamba-2's), the convolutions U(-1/2, 1/2),
    each ``x`` N(0, 1).  Returns (the layers: a dict a layer of its weights
    by name, in argument order; the identity RoPE tables (cos, sin); the
    list of ``x``)."""
    s = shape(cfg)
    dtype = DTYPES[s["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    types = held_types(cfg)
    stacked = {}
    for kind in ("linear_attention", "full_attention"):
        count = types.count(kind)
        weights = {}
        for name, shp in weight_shapes(s, kind).items():
            full = (count,) + shp
            if name == "A_log":
                t = hybrid_layer._uniform(gen, full, *hybrid_layer.A_RANGE, device,
                                          torch.float32).log_()
            elif name == "dt_bias":
                lo, hi = (math.log(v) for v in hybrid_layer.DT_RANGE)
                dt = hybrid_layer._uniform(gen, full, lo, hi, device, torch.float32).exp_()
                t = dt + torch.log(-torch.expm1(-dt))
            elif name.startswith("conv_"):
                b = hybrid_layer.CONV_BOUND
                t = hybrid_layer._uniform(gen, full, -b, b, device, torch.float32)
            else:
                t = torch.randn(full, generator=gen, device=device, dtype=dtype).mul_(WEIGHT_STD)
                if name.startswith("g"):
                    t.add_(1.0)
            weights[name] = t.to(dtype)
        stacked[kind] = weights
    seen = {"linear_attention": 0, "full_attention": 0}
    layers = []
    for kind in types:
        i = seen[kind]
        seen[kind] += 1
        layers.append({name: t[i] for name, t in stacked[kind].items()})
    tables = hybrid_layer.nope_tables(seq, s["head_dim"], dtype, device)
    n = batch * seq
    xs = torch.randn(distinct * n, s["d"], generator=gen, device=device, dtype=dtype)
    return layers, tables, list(xs.split(n))


# ---------------------------------------------------------------------------
# the work of one request, counted from the shapes
# ---------------------------------------------------------------------------

def deltanet_counts(cfg: dict, batch: int, seq: int) -> dict:
    """One Gated DeltaNet layer's work: its library products (q, k, v, a,
    b, the gate, ``W_o`` and the MLP's three), and the rest as the outputs
    need it.

    The rest's operations are the chunked delta rule's products.  Within
    each chunk of ``c`` positions, a head: ``k_beta kᵀ`` over the strictly
    lower (i, j) pairs; the forward substitution, row i adding the products
    of its j < k < i pairs; ``u = T (beta v)`` and ``w = T (beta k e^g)``
    over T's lower pairs; ``q kᵀ`` and ``attn v_new`` over the causal
    pairs.  Between chunks: ``w S`` and ``q S`` for every chunk after the
    first (the first reads a zero state), ``kᵀ v_new`` for every chunk
    before the last (the last state is not read).  Its bytes are each
    tensor the rest reads once and writes once: the input, the six small
    projections' outputs (q, k, v, a, b, the gate; read), the three
    convolutions' weights, ``A_log``, ``dt_bias``, ``g_norm``, the mixer's
    output before ``W_o`` (written) and after (read), the gain ``g``, the
    residual stream written and read again, the gate's and up's outputs
    (read), their product (written), the down projection's output (read),
    ``g2`` and the layer's output (written)."""
    s = shape(cfg)
    d, ff, heads, dk, dv = s["d"], s["ff"], s["lin_heads"], s["dk"], s["dv"]
    c, kd, vd = s["chunk"], s["key_dim"], s["value_dim"]
    tokens, n = batch * seq, seq // c
    gemms = [(tokens, d, kd), (tokens, d, kd), (tokens, d, vd), (tokens, d, heads),
             (tokens, d, heads), (tokens, d, vd), (tokens, vd, d), (tokens, d, ff),
             (tokens, d, ff), (tokens, ff, d)]

    def delta_flops(strict: float, lower: float, substitution: float, chunks: int,
                    carried: int) -> float:
        """The products over ``strict`` strictly lower and ``lower`` lower
        (diagonal included) pairs of a chunk, ``substitution`` operations
        of the forward substitution, ``chunks`` chunks a head, and the
        state products of ``carried`` chunks a head."""
        within = (2.0 * dk * strict                     # k_beta kᵀ
                  + substitution                        # T
                  + 2.0 * lower * (dv + dk)             # u and w
                  + 2.0 * lower * dk                    # q kᵀ
                  + 2.0 * lower * dv)                   # attn v_new
        return batch * heads * (chunks * within + 3 * carried * 2.0 * c * dk * dv)

    elems = (tokens * d                                   # x
             + tokens * (2 * kd + vd + 2 * heads + vd)    # q, k, v, a, b, the gate
             + s["d_conv"] * (2 * kd + vd) + 2 * heads + dv  # convs, A_log, dt_bias, g_norm
             + tokens * vd + tokens * d + d               # the mixer's output, W_o's, g
             + 2 * tokens * d                             # x after the mixer, written and read
             + 2 * tokens * ff + tokens * ff              # gate, up, their product
             + tokens * d + d + tokens * d)               # down's output, g2, the layer's
    return {"gemm_flops": sum(work.gemm_flops(*g) for g in gemms),
            "gemm_bytes": sum(work.gemm_bytes(*g, itemsize=work.ITEMSIZE[s["dtype"]])
                              for g in gemms),
            "fused_flops": delta_flops(c * (c - 1) / 2, c * (c + 1) / 2,
                                       (c - 1) * c * (c - 2) / 3, n, n - 1),
            "fused_flops_dense": delta_flops(c * c, c * c, (c - 1) * c * (2 * c - 1) / 3, n, n),
            "fused_bytes": float(work.ITEMSIZE[s["dtype"]] * elems)}


def deltanet_seconds_at_roofline(cfg: dict, batch: int, seq: int) -> float:
    """The least time one H100 could take over one Gated DeltaNet layer's
    work outside its library products (``deltanet_counts``)."""
    c = deltanet_counts(cfg, batch, seq)
    return work.seconds_at_roofline(c["fused_flops"], c["fused_bytes"],
                                    work.PEAK_FLOPS[shape(cfg)["dtype"]])


def full_config(cfg: dict) -> dict:
    """The configuration ``work.decoder_stack`` counts a full-attention
    layer of."""
    return dict(cfg, mlp="gated_silu", tensor_parallel=1)


def WORK(cfg: dict, batch: int, seq: int) -> work.Work:
    """What one request needs: each full-attention layer's work as
    ``work.decoder_stack`` counts it, with the gated MLP (the QK-norm's
    gains aside), and each Gated DeltaNet layer's as ``deltanet_counts``
    does."""
    types = held_types(cfg)
    k = types.count("linear_attention")
    full = work.decoder_stack(dict(full_config(cfg), num_hidden_layers=len(types) - k),
                              batch, seq)
    g = deltanet_counts(cfg, batch, seq)
    return work.Work(
        tokens=batch * seq,
        gemm_flops=full.gemm_flops + k * g["gemm_flops"],
        gemm_bytes=full.gemm_bytes + k * g["gemm_bytes"],
        fused_flops=full.fused_flops + k * g["fused_flops"],
        fused_flops_dense=full.fused_flops_dense + k * g["fused_flops_dense"],
        fused_bytes=full.fused_bytes + k * g["fused_bytes"],
        peak_flops=work.PEAK_FLOPS[shape(cfg)["dtype"]],
    )
