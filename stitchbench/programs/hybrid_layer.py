"""A hybrid stack of Mamba-2 and attention layers, as a user hands one layer
to ``repro_torch.stitch``: granite-4.0-h's ``granitemoehybrid`` layers.

Every layer is pre-norm with two scaled residual adds: its mixer, then the
gated SiLU MLP (``decoder_layer``'s).  The mixer of a layer is the one its
entry of ``layer_types`` names:

* ``attention``: ``decoder_layer``'s attention sublayer, grouped-query and
  causal, with no positional encoding: the benchmark passes RoPE tables of
  cos 1 and sin 0, and ``t * 1 + rot * 0`` is ``t``;
* ``mamba``: the Mamba-2 mixer, written as a user writes it.  ``W_in``
  projects to the gate ``z``, ``xBC`` and ``dt``; ``xBC`` goes through a
  causal depthwise ``conv1d`` and SiLU and splits into ``x``, ``B`` and
  ``C``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the state
  space runs as the published chunked SSD (``ssd_minimal_discrete`` of
  state-spaces/mamba: ``cumsum``, a segment sum under ``masked_fill``,
  ``einsum``, ``F.pad`` and ``torch.cat``, each einsum of two operands so
  that the contraction order is the program's own); ``y + D * x`` is gated
  by ``silu(z)``, normed over the inner width and projected by ``W_out``.

``build`` returns one function whose weights follow ``x``: the two kinds
of layer take different arguments, so ``stitch`` keeps a plan for each.
The frontend lowers every op here: the convolution as its shifted slices,
the splits and the pad as slices and concats, ``cumsum`` as a running sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stitchbench import work
from stitchbench.programs import decoder_layer

WEIGHT_STD = decoder_layer.WEIGHT_STD
DTYPES = decoder_layer.DTYPES
#: ``A_log = log U(A_RANGE)`` and ``dt = exp(U(log DT_RANGE))``, as Mamba-2
#: initialises them; ``dt_bias`` is ``dt``'s inverse softplus
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 0.1)
#: the causal convolution's weight and bias are U(-CONV_BOUND, CONV_BOUND)
CONV_BOUND = 0.5
MAMBA_WEIGHTS = ("g", "w_in", "conv_w", "conv_b", "dt_bias", "A_log", "D", "g_norm", "w_out",
                 "g2", "wg", "wu", "wd")
ATTENTION_WEIGHTS = ("g", "wq", "wk", "wv", "wo", "g2", "wg", "wu", "wd")


def held_types(cfg: dict) -> list:
    """The ``layer_types`` of the layers held, in order."""
    lo, hi = cfg["layers_held"]
    return list(cfg["layer_types"][lo:hi])


def attention_config(cfg: dict) -> dict:
    """The configuration ``decoder_layer`` builds the attention layer of."""
    return dict(cfg, mlp="gated_silu", tensor_parallel=1)


def shape(cfg: dict) -> dict:
    """The sizes this chip holds: every width as published."""
    if cfg["mamba_n_groups"] != 1:
        raise NotImplementedError("the program writes the SSD for one group of B and C")
    s = decoder_layer.shape(attention_config(cfg))
    heads, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    s.update(layers=cfg["num_hidden_layers"], mamba_heads=heads, mamba_head_dim=hd,
             d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
             chunk=cfg["mamba_chunk_size"], inner=heads * hd,
             conv_dim=heads * hd + 2 * cfg["mamba_d_state"])
    if s["inner"] != cfg["mamba_expand"] * s["d"]:
        raise ValueError("mamba_n_heads * mamba_d_head is not mamba_expand * hidden_size")
    return s


def weight_shapes(s: dict, kind: str) -> dict:
    """Each weight of one layer of ``kind``, by name, with its shape."""
    mlp = {"g2": (s["d"],), "wg": (s["d"], s["ff"]), "wu": (s["d"], s["ff"]),
           "wd": (s["ff"], s["d"])}
    if kind == "attention":
        return decoder_layer.weight_shapes(s)
    d, inner, heads = s["d"], s["inner"], s["mamba_heads"]
    return {"g": (d,), "w_in": (d, inner + s["conv_dim"] + heads),
            "conv_w": (s["conv_dim"], 1, s["d_conv"]), "conv_b": (s["conv_dim"],),
            "dt_bias": (heads,), "A_log": (heads,), "D": (heads,), "g_norm": (inner,),
            "w_out": (inner, d), **mlp}


def args(cfg: dict):
    """The first held layer's arguments after ``x``, in order."""
    kind = held_types(cfg)[0]
    return (MAMBA_WEIGHTS if kind == "mamba" else ATTENTION_WEIGHTS) + ("cos", "sin")


def build(cfg: dict, batch: int, seq: int):
    """The function the benchmark compiles: one layer of either kind, told
    apart by its arguments, for one configuration's widths and one traffic
    mix's (batch, seq)."""
    s = shape(cfg)
    eps, res_scale = cfg["rms_norm_eps"], cfg["residual_scale"]
    heads, hd, n = s["mamba_heads"], s["mamba_head_dim"], s["d_state"]
    inner, conv_dim, q = s["inner"], s["conv_dim"], s["chunk"]
    if seq % q:
        raise ValueError(f"seq {seq} is no multiple of the SSD's chunk {q}")
    chunks = seq // q
    attention = decoder_layer.build(attention_config(cfg), batch, seq)

    def rms(x, g):
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g

    def segsum(x):
        t = x.size(-1)
        x = x[..., None].expand(*x.shape, t)
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=-1)
        x = x.masked_fill(~mask, 0)
        x_segsum = torch.cumsum(x, dim=-2)
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=0)
        return x_segsum.masked_fill(~mask, -torch.inf)

    def ssd(x, a, b, c):
        """``ssd_minimal_discrete``: x (batch, seq, heads, hd) already times
        dt, a (batch, seq, heads) = A dt, b and c (batch, seq, n)."""
        x = x.reshape(batch, chunks, q, heads, hd)
        a = a.reshape(batch, chunks, q, heads).permute(0, 3, 1, 2)
        b = b.reshape(batch, chunks, q, n)
        c = c.reshape(batch, chunks, q, n)
        a_cumsum = torch.cumsum(a, dim=-1)
        # 1. the outputs within each chunk
        decay = torch.exp(segsum(a))
        scores = torch.einsum("bcln,bcsn->bcls", c, b)
        y_diag = torch.einsum("bhcls,bcshp->bclhp", scores[:, None] * decay, x)
        # 2. each chunk's final state
        decay_states = torch.exp(a_cumsum[:, :, :, -1:] - a_cumsum)
        states = torch.einsum("bcln,bclhp->bchpn", b,
                              x * decay_states.permute(0, 2, 3, 1)[..., None])
        # 3. the recurrence between chunks
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        decay_chunk = torch.exp(segsum(F.pad(a_cumsum[:, :, :, -1], (1, 0))))
        states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
        # 4. each chunk's starting state to its outputs
        y_off = (torch.einsum("bcln,bchpn->bclhp", c, states)
                 * torch.exp(a_cumsum).permute(0, 2, 3, 1)[..., None])
        return (y_diag + y_off).reshape(batch, seq, heads, hd)

    def mixer(h, w_in, conv_w, conv_b, dt_bias, a_log, d_skip, g_norm, w_out):
        z, xbc, dt = torch.split(torch.matmul(h, w_in), [inner, conv_dim, heads], dim=-1)
        xbc = xbc.reshape(batch, seq, conv_dim).transpose(1, 2)
        xbc = F.conv1d(xbc, conv_w, conv_b, padding=s["d_conv"] - 1, groups=conv_dim)[..., :seq]
        xs, b, c = torch.split(F.silu(xbc).transpose(1, 2), [inner, n, n], dim=-1)
        dt = F.softplus(dt.reshape(batch, seq, heads) + dt_bias)
        a = -torch.exp(a_log)
        xs = xs.reshape(batch, seq, heads, hd)
        y = ssd(xs * dt[..., None], a * dt, b, c) + xs * d_skip[:, None]
        y = y.reshape(batch * seq, inner) * F.silu(z)
        return torch.matmul(rms(y, g_norm), w_out)

    def mamba_layer(x, g, w_in, conv_w, conv_b, dt_bias, a_log, d_skip, g_norm, w_out,
                    g2, wg, wu, wd, cos, sin):
        x = x + mixer(rms(x, g), w_in, conv_w, conv_b, dt_bias, a_log, d_skip, g_norm,
                      w_out) * res_scale
        h = rms(x, g2)
        m = F.silu(torch.matmul(h, wg)) * torch.matmul(h, wu)
        return x + torch.matmul(m, wd) * res_scale

    def hybrid_layer(x, *weights):
        if len(weights) == len(ATTENTION_WEIGHTS) + 2:
            return attention(x, *weights)
        return mamba_layer(x, *weights)

    return hybrid_layer


def nope_tables(seq: int, head_dim: int, dtype, device):
    """RoPE tables of no rotation: cos 1 and sin 0 at every position."""
    return (torch.ones(seq, head_dim, dtype=dtype, device=device),
            torch.zeros(seq, head_dim, dtype=dtype, device=device))


def _uniform(gen, shape, lo, hi, device, dtype):
    return torch.rand(shape, generator=gen, device=device, dtype=dtype).mul_(hi - lo).add_(lo)


def make_inputs(cfg: dict, batch: int, seq: int, seed: int, distinct: int, device):
    """The weights of every held layer and ``distinct`` inputs ``x`` of one
    run, drawn on ``device`` from ``seed`` in the configuration's type, one
    draw a kind of weight of each kind of layer: the projections N(0, 0.02),
    the gains 1 + N(0, 0.02), ``A_log = log U(1, 16)``, ``dt_bias`` the
    inverse softplus of a log-uniform ``dt`` in [1e-3, 0.1], ``D = 1``, the
    convolution's weight and bias U(-1/2, 1/2), each ``x`` N(0, 1).
    Returns (the layers: a dict a layer of its weights by name, in argument
    order; the identity RoPE tables (cos, sin); the list of ``x``)."""
    s = shape(cfg)
    dtype = DTYPES[s["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    types = held_types(cfg)
    stacked = {}
    for kind in ("mamba", "attention"):
        count = types.count(kind)
        weights = {}
        for name, shp in weight_shapes(s, kind).items():
            full = (count,) + shp
            if name == "A_log":
                t = _uniform(gen, full, *A_RANGE, device, torch.float32).log_()
            elif name == "dt_bias":
                lo, hi = (math.log(v) for v in DT_RANGE)
                dt = _uniform(gen, full, lo, hi, device, torch.float32).exp_()
                t = dt + torch.log(-torch.expm1(-dt))
            elif name == "D":
                t = torch.ones(full, device=device)
            elif name in ("conv_w", "conv_b"):
                t = _uniform(gen, full, -CONV_BOUND, CONV_BOUND, device, torch.float32)
            else:
                t = torch.randn(full, generator=gen, device=device, dtype=dtype).mul_(WEIGHT_STD)
                if name.startswith("g"):
                    t.add_(1.0)
            weights[name] = t.to(dtype)
        stacked[kind] = weights
    seen = {"mamba": 0, "attention": 0}
    layers = []
    for kind in types:
        i = seen[kind]
        seen[kind] += 1
        layers.append({name: t[i] for name, t in stacked[kind].items()})
    tables = nope_tables(seq, s["head_dim"], dtype, device)
    n = batch * seq
    xs = torch.randn(distinct * n, s["d"], generator=gen, device=device, dtype=dtype)
    return layers, tables, list(xs.split(n))


# ---------------------------------------------------------------------------
# the work of one request, counted from the shapes
# ---------------------------------------------------------------------------

def mamba_counts(cfg: dict, batch: int, seq: int) -> dict:
    """One Mamba-2 layer's work: its library products (``W_in``, ``W_out``
    and the MLP's three), and the rest as the outputs need it.

    The rest's operations are the SSD's products as the chunked outputs
    need them: within each chunk, C Bᵀ and its product with x over the
    causal half of each chunk's (l, s) pairs; each chunk's state, B times
    the decayed x; the chunks' states carried forward, each chunk's state
    from the states before it; and C times each chunk's starting state.
    Its bytes are each tensor the rest reads once and writes once: the
    input, the gains, ``W_in``'s output (read), the convolution's weight
    and bias, ``dt_bias``, ``A_log``, ``D``, the mixer's output before
    ``W_out`` (written) and after (read), the residual stream written and
    read again by the MLP's norm, the normed ``h`` of each norm (written),
    the gate's and up's outputs (read), their product (written), the down
    projection's output (read) and the layer's output (written)."""
    s = shape(cfg)
    d, ff, inner, heads = s["d"], s["ff"], s["inner"], s["mamba_heads"]
    hd, n, q, conv_dim = s["mamba_head_dim"], s["d_state"], s["chunk"], s["conv_dim"]
    tokens, chunks = batch * seq, batch * (seq // q)
    proj = inner + conv_dim + heads
    gemms = [(tokens, d, proj), (tokens, inner, d), (tokens, d, ff), (tokens, d, ff),
             (tokens, ff, d)]

    def ssd_flops(pairs: float, carried_pairs: float) -> float:
        """The SSD's products over ``pairs`` (l, s) pairs of each chunk and
        ``carried_pairs`` (z, c) pairs of the chunks' recurrence."""
        return (2.0 * chunks * pairs * n                     # C Bᵀ
                + 2.0 * chunks * heads * pairs * hd           # its product with x
                + 2.0 * chunks * q * n * inner                # each chunk's state
                + 2.0 * batch * heads * carried_pairs * hd * n  # the states carried forward
                + 2.0 * chunks * q * n * inner)               # C times each starting state

    c = seq // q
    elems = (tokens * d + d                               # x, g
             + tokens * proj + conv_dim * s["d_conv"] + conv_dim + 3 * heads
             + inner                                      # W_in's output, conv, dt_bias, A_log, D, g_norm
             + tokens * inner + tokens * d                # the mixer's output, W_out's
             + 2 * tokens * d + d                         # x after the mixer, written and read; g2
             + 2 * tokens * d                             # both norms' h
             + 2 * tokens * ff + tokens * ff              # gate, up, their product
             + tokens * d + tokens * d)                   # down's output, the layer's
    return {"gemm_flops": sum(work.gemm_flops(*g) for g in gemms),
            "gemm_bytes": sum(work.gemm_bytes(*g, itemsize=work.ITEMSIZE[s["dtype"]]) for g in gemms),
            "fused_flops": ssd_flops(q * (q + 1) / 2, c * (c + 1) / 2),
            "fused_flops_dense": ssd_flops(q * q, c * c),
            "fused_bytes": float(work.ITEMSIZE[s["dtype"]] * elems)}


def mamba_seconds_at_roofline(cfg: dict, batch: int, seq: int) -> float:
    """The least time one H100 could take over one Mamba-2 layer's work
    outside its library products (``mamba_counts``)."""
    c = mamba_counts(cfg, batch, seq)
    return work.seconds_at_roofline(c["fused_flops"], c["fused_bytes"],
                                    work.PEAK_FLOPS[shape(cfg)["dtype"]])


def WORK(cfg: dict, batch: int, seq: int) -> work.Work:
    """What one request needs: each attention layer's work as
    ``work.decoder_stack`` counts it, with the gated MLP, and each Mamba-2
    layer's as ``mamba_counts`` does."""
    types = held_types(cfg)
    attn = work.decoder_stack(dict(attention_config(cfg), num_hidden_layers=types.count("attention")),
                              batch, seq)
    m = mamba_counts(cfg, batch, seq)
    k = types.count("mamba")
    return work.Work(
        tokens=batch * seq,
        gemm_flops=attn.gemm_flops + k * m["gemm_flops"],
        gemm_bytes=attn.gemm_bytes + k * m["gemm_bytes"],
        fused_flops=attn.fused_flops + k * m["fused_flops"],
        fused_flops_dense=attn.fused_flops_dense + k * m["fused_flops_dense"],
        fused_bytes=attn.fused_bytes + k * m["fused_bytes"],
        peak_flops=work.PEAK_FLOPS[shape(cfg)["dtype"]],
    )
