"""The ten paper graphs, built with the port's ``GraphBuilder``.

The same workloads as the reference's ``benchmarks/graphs.py`` ``ALL_GRAPHS``
at the same dimensions (LR, W2V, RNN, BiRNN, Speech, NMT, Stacked,
ReduceTowers, BcastHeavy, StitchPipe), instruction for instruction, so a
module built here and one carried across with ``module_from_reference``
have the same opcodes, shapes, dtypes, attrs and wiring.  ``random_feeds``
draws the same numpy feeds from the same ``RandomState``.

``TORCH_FAMILIES`` pairs three of them with ordinary PyTorch functions of
the same computation, the counterparts of the reference's ``JNP_FAMILIES``:
``repro_torch.stitch`` of each must commit the hand-built module's plan.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .core.ir import BFLOAT16, GraphBuilder, Module

F32 = np.float32
I32 = np.int32


def random_feeds(module: Module, rng) -> dict:
    """Random feeds for every module parameter: int32 parameters get small
    first-dim-bounded indices, floats uniform(-1, 1) (bfloat16 ones drawn
    as float32, which the runtime rounds)."""
    out = {}
    for p in module.parameters:
        if np.dtype(p.dtype) == np.int32:
            out[p.name] = rng.randint(
                0, max(2, p.shape[0] if p.shape else 2), size=p.shape
            ).astype(np.int32)
        else:
            dt = np.float32 if np.dtype(p.dtype) == BFLOAT16 else np.dtype(p.dtype)
            out[p.name] = rng.uniform(-1, 1, size=p.shape).astype(dt)
    return out


LR_DIM = (64, 16)          # batch, features
W2V_DIM = (64, 32, 512)    # batch, embed dim, vocab
RNN_STEPS = 6
SPEECH_DIM = (8, 50, 40)   # batch, frames, filters
NMT_DIM = (4, 8, 32, 16)   # batch, heads, seq, head_dim


def lr_graph() -> Module:
    """Logistic-regression training step: fwd + grads + SGD updates."""
    b = GraphBuilder("LR")
    B, D = LR_DIM
    x = b.parameter("x", (B, D), F32)
    y = b.parameter("y", (B, 1), F32)
    W = b.parameter("W", (D, 1), F32)
    bias = b.parameter("b", (1,), F32)
    z = b.dot(x, W)                                    # LC
    p = b.sigmoid(z + b.broadcast(bias, (B, 1), (1,)))
    e = p - y
    xt = b.transpose(x, (1, 0))
    dW = b.dot(xt, e)                                  # LC
    _W2 = W - dW * 0.1                                 # update kernel
    db = b.reduce(e, (0, 1), "mean")
    _b2 = bias - b.broadcast(db, (1,), ()) * 0.1
    lp = b.log(b.maximum(p, 1e-6))
    ln = b.log(b.maximum(1.0 - p, 1e-6))
    _loss = b.reduce(0.0 - (y * lp + (1.0 - y) * ln), (0, 1), "mean")
    return b.module


def w2v_graph() -> Module:
    """Word2vec negative-sampling step: gathers + elementwise grads."""
    b = GraphBuilder("W2V")
    B, D, V = W2V_DIM
    t_in = b.parameter("emb_in", (V, D), F32)
    t_out = b.parameter("emb_out", (V, D), F32)
    idx = b.parameter("center", (B,), I32)
    ctx = b.parameter("context", (B,), I32)
    lbl = b.parameter("label", (B,), F32)
    ein = b.gather(t_in, idx)                          # (B, D)
    eout = b.gather(t_out, ctx)
    score = b.reduce(ein * eout, (1,), "sum")          # (B,)
    p = b.sigmoid(score)
    g = p - lbl
    gb = b.broadcast(g, (B, D), (0,))
    _d_in = ein - gb * eout * 0.05                     # updated rows
    _d_out = eout - gb * ein * 0.05
    return b.module


def _rnn_cell(b, x_t, h, Wx, Wh, bias):
    a = b.dot(x_t, Wx)                                 # LC
    c = b.dot(h, Wh)                                   # LC
    s = a + c + b.broadcast(bias, a.shape, (1,))
    return b.tanh(s)


def rnn_graph(steps: int = RNN_STEPS, name="RNN") -> Module:
    b = GraphBuilder(name)
    B, D, H = 16, 24, 32
    Wx = b.parameter("Wx", (D, H), F32)
    Wh = b.parameter("Wh", (H, H), F32)
    bias = b.parameter("b", (H,), F32)
    h = b.parameter("h0", (B, H), F32)
    for t in range(steps):
        x_t = b.parameter(f"x{t}", (B, D), F32)
        h = _rnn_cell(b, x_t, h, Wx, Wh, bias)
    Wo = b.parameter("Wo", (H, 8), F32)
    logits = b.dot(h, Wo)                              # LC
    _probs = b.softmax(logits, dim=-1)
    return b.module


def birnn_graph(steps: int = RNN_STEPS) -> Module:
    b = GraphBuilder("BiRNN")
    B, D, H = 16, 24, 32
    xs = [b.parameter(f"x{t}", (B, D), F32) for t in range(steps)]
    hf = b.parameter("hf0", (B, H), F32)
    hb = b.parameter("hb0", (B, H), F32)
    Wxf = b.parameter("Wxf", (D, H), F32)
    Whf = b.parameter("Whf", (H, H), F32)
    bf = b.parameter("bf", (H,), F32)
    Wxb = b.parameter("Wxb", (D, H), F32)
    Whb = b.parameter("Whb", (H, H), F32)
    bb = b.parameter("bb", (H,), F32)
    for t in range(steps):
        hf = _rnn_cell(b, xs[t], hf, Wxf, Whf, bf)
    for t in reversed(range(steps)):
        hb = _rnn_cell(b, xs[t], hb, Wxb, Whb, bb)
    hcat = b.concat([hf, hb], dim=1)                   # (B, 2H)
    Wo = b.parameter("Wo", (2 * H, 8), F32)
    _out = b.softmax(b.dot(hcat, Wo), dim=-1)
    return b.module


def speech_graph() -> Module:
    """Acoustic frontend head: square/log/reduce/transpose/concat mix."""
    b = GraphBuilder("Speech")
    B, T, F = SPEECH_DIM
    x = b.parameter("frames", (B, T, F), F32)
    mel_w = b.parameter("mel", (F, F), F32)
    power = b.square(x)
    flat = b.reshape(power, (B * T, F))
    mel = b.dot(flat, mel_w)                           # LC
    lg = b.log(b.maximum(b.reshape(mel, (B, T, F)), 1e-6))
    mu = b.reduce(lg, (1,), "mean")                    # (B, F)
    mub = b.broadcast(mu, (B, T, F), (0, 2))
    cen = lg - mub
    var = b.reduce(b.square(cen), (1,), "mean")
    inv = b.rsqrt(var + 1e-5)
    norm = cen * b.broadcast(inv, (B, T, F), (0, 2))
    tr = b.transpose(norm, (0, 2, 1))                  # (B, F, T)
    delta = tr * 0.5 + 0.1
    feats = b.concat([tr, delta], dim=1)               # (B, 2F, T)
    gate = b.sigmoid(feats)
    _out = b.reduce(gate * feats, (2,), "mean")        # (B, 2F)
    return b.module


def nmt_graph(fuse_dot: bool = True) -> Module:
    """The paper's Figure-3 subgraph: softmax stitched with BatchMatMul."""
    b = GraphBuilder("NMT")
    B, H, S, D = NMT_DIM
    q = b.parameter("q", (B, H, S, D), F32)
    k = b.parameter("k", (B, H, S, D), F32)
    v = b.parameter("v", (B, H, S, D), F32)
    bias = b.parameter("bias", (S, S), F32)
    kt = b.transpose(k, (0, 1, 3, 2))
    scores = b.dot(q, kt, fusable=fuse_dot)
    scaled = scores * (1.0 / D ** 0.5) + b.broadcast(bias, scores.shape, (2, 3))
    p = b.softmax(scaled, dim=-1)
    ctx = b.dot(p, v, fusable=fuse_dot)
    _out = b.tanh(ctx)
    return b.module


def stacked_transformer_graph(num_layers: int = 8) -> Module:
    """N structurally-identical pre-norm blocks separated by library
    MatMuls: every middle layer's fusion has the same signature."""
    b = GraphBuilder("Stacked")
    B, D = 16, 64
    x = b.parameter("x", (B, D), F32)
    for layer in range(num_layers):
        g = b.parameter(f"g{layer}", (D,), F32)
        W = b.parameter(f"W{layer}", (D, D), F32)
        ms = b.reduce(b.square(x), (1,), "mean")
        inv = b.rsqrt(ms + 1e-6)
        normed = x * b.broadcast(inv, (B, D), (0,)) * b.broadcast(g, (B, D), (1,))
        h = b.dot(normed, W)                           # LC: layer boundary
        x = x + b.silu(h)
    return b.module


def reduce_towers_graph(num_towers: int = 6) -> Module:
    """N independent square/scale/reduce towers with reduce sinks — packed
    into one multi-root kernel by the cost-guided planner."""
    b = GraphBuilder("ReduceTowers")
    B, D = 32, 64
    for i in range(num_towers):
        x = b.parameter(f"x{i}", (B, D), F32)
        s = b.parameter(f"s{i}", (B, D), F32)
        e = b.square(x * 0.5 + s)
        _ = b.reduce(e * e, (0, 1), "sum")
    return b.module


def broadcast_towers_graph(num_towers: int = 5) -> Module:
    """Broadcast/replication-heavy towers ending in reshape sinks."""
    b = GraphBuilder("BcastHeavy")
    B, D = 16, 32
    for i in range(num_towers):
        x = b.parameter(f"x{i}", (B, D), F32)
        g = b.parameter(f"g{i}", (D,), F32)
        scaled = x * b.broadcast(g, (B, D), (1,))
        m = b.reduce(scaled, (1,), "mean")             # (B,)
        cen = scaled - b.broadcast(m, (B, D), (0,))
        _ = b.reshape(b.sigmoid(cen), (B * D,))        # flat sink
    return b.module


def stitch_pipeline_graph() -> Module:
    """A wide row-softmax feeding a full 2-D transpose and a tail: no single
    block schedule crosses the transpose, so it lowers as ONE multi-phase
    stitched kernel."""
    b = GraphBuilder("StitchPipe")
    B, D = 512, 320
    x = b.parameter("x", (B, D), F32)
    g = b.parameter("g", (D,), F32)
    scaled = x * b.broadcast(g, (B, D), (1,))
    mx = b.reduce(scaled, (1,), "max")
    e = b.exp(scaled - b.broadcast(mx, (B, D), (0,)))
    s = b.reduce(e, (1,), "sum")
    p = e / b.broadcast(s, (B, D), (0,))
    t = b.transpose(p, (1, 0))                         # (D, B): the break
    _out = b.tanh(t) * 0.5
    return b.module


ALL_GRAPHS = {
    "LR": lr_graph,
    "W2V": w2v_graph,
    "RNN": rnn_graph,
    "BiRNN": birnn_graph,
    "Speech": speech_graph,
    "NMT": nmt_graph,
    "Stacked": stacked_transformer_graph,
    "ReduceTowers": reduce_towers_graph,
    "BcastHeavy": broadcast_towers_graph,
    "StitchPipe": stitch_pipeline_graph,
}


# --------------------------------------------------------------------------
# Loop modules: ``call``/``get`` over a body module.  Each takes the
# ``GraphBuilder`` class to build with, so the same module can be built by
# the port and, in the tests, by the reference.
# --------------------------------------------------------------------------


def rnn_scan_graph(builder=GraphBuilder, steps: int = RNN_STEPS) -> Module:
    """The RNN graph's recurrence as one loop: the cell of ``rnn_graph`` at
    its dimensions (B 16, D 24, H 32) run ``steps`` times over stacked xs
    (steps, B, D), with h carried and every step's h stacked as ys."""
    B, D, H = 16, 24, 32
    body = builder("rnn_cell")
    Wx = body.parameter("Wx", (D, H), F32)
    Wh = body.parameter("Wh", (H, H), F32)
    bias = body.parameter("b", (H,), F32)
    h = body.parameter("h", (B, H), F32)
    x_t = body.parameter("x", (B, D), F32)
    _rnn_cell(body, x_t, h, Wx, Wh, bias)
    b = builder("RNNScan")
    args = [b.parameter(n, s, F32) for n, s in
            (("Wx", (D, H)), ("Wh", (H, H)), ("b", (H,)), ("h0", (B, H)), ("xs", (steps, B, D)))]
    loop = b.call_loop(args, body.module, trip_count=steps, num_consts=3, num_carry=1,
                       out_order=(0, 0), out_shapes=((B, H), (steps, B, H)),
                       out_dtypes=(F32, F32))
    b.get(loop, 0)
    b.get(loop, 1)
    return b.module


def _decode_body(builder, name: str):
    body = builder(name)
    w = body.parameter("w", (16, 16), F32)
    c = body.parameter("c", (4, 16), F32)
    nc = body.tanh(body.dot(c, w))
    body.reshape(nc, (4, 16))        # the carry's root (nc itself has a user)
    body.reduce(nc, (1,), "sum")
    return body


def decode_loop_graph(builder=GraphBuilder, steps: int = 6, name: str = "DecodeLoop") -> Module:
    """``lax.scan`` of ``carry = tanh(carry @ w)`` with no xs, each step's
    row sums stacked as ys: the decode loop of the reference's control-flow
    tests, carry (4, 16)."""
    body = _decode_body(builder, "decode_step")
    b = builder(name)
    w0, h = b.parameter("w", (16, 16), F32), b.parameter("h", (4, 16), F32)
    loop = b.call_loop([w0, h], body.module, trip_count=steps, num_consts=1, num_carry=1,
                       out_order=(0, 1), out_shapes=((4, 16), (steps, 4)),
                       out_dtypes=(F32, F32))
    b.get(loop, 0)
    b.get(loop, 1)
    return b.module


def reverse_scan_graph(builder=GraphBuilder, steps: int = 5) -> Module:
    """``lax.scan(..., reverse=True)`` over xs (steps, 8): ``c = c * 0.9 +
    x`` carried, ``c - x`` stacked, as in the reference's control-flow
    tests."""
    body = builder("decay_step")
    c = body.parameter("c", (8,), F32)
    x = body.parameter("x", (8,), F32)
    nc = c * 0.9 + x
    body.reshape(nc, (8,))           # the carry's root (nc itself has a user)
    _y = nc - x
    b = builder("ReverseScan")
    init, xs = b.parameter("init", (8,), F32), b.parameter("xs", (steps, 8), F32)
    loop = b.call_loop([init, xs], body.module, trip_count=steps, num_consts=0, num_carry=1,
                       out_order=(0, 1), out_shapes=((8,), (steps, 8)), out_dtypes=(F32, F32),
                       reverse=True)
    b.get(loop, 0)
    b.get(loop, 1)
    return b.module


def two_scans_graph(builder=GraphBuilder) -> Module:
    """Two decode loops of the same body structure, the second fed by the
    first's final carry: one compiled body serves both call sites."""
    b = builder("TwoScans")
    w = b.parameter("w", (16, 16), F32)
    h = b.parameter("h", (4, 16), F32)
    for k in range(2):
        body = _decode_body(builder, f"decode_step{k}")
        loop = b.call_loop([w, h], body.module, trip_count=4, num_consts=1, num_carry=1,
                           out_order=(0, 1), out_shapes=((4, 16), (4, 4)), out_dtypes=(F32, F32))
        h = b.get(loop, 0)
        b.get(loop, 1)
    return b.module


LOOP_GRAPHS = {
    "RNNScan": rnn_scan_graph,
    "DecodeLoop": decode_loop_graph,
    "ReverseScan": reverse_scan_graph,
    "TwoScans": two_scans_graph,
}


# --------------------------------------------------------------------------
# Frontend-parity families: ordinary PyTorch functions — zero GraphBuilder
# calls — captured through ``repro_torch.stitch``, each paired with the
# hand-built module above.  The functions and their ``*_args`` (numpy,
# from a ``RandomState``) are the reference's ``nmt_fn``, ``stacked_fn``
# and ``reduce_towers_fn`` (``benchmarks/graphs.py``) rewritten in torch.
# --------------------------------------------------------------------------


def nmt_fn(q, k, v, bias):
    """Figure-3 attention (softmax stitched with BatchMatMul) in plain
    torch — mirrors ``nmt_graph``."""
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2))
    scaled = scores * (1.0 / d ** 0.5) + bias
    mx = torch.amax(scaled, dim=-1, keepdim=True)
    e = torch.exp(scaled - mx)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    return torch.tanh(torch.matmul(p, v))


def nmt_args(rng):
    B, H, S, D = NMT_DIM
    return (
        rng.randn(B, H, S, D).astype("f4"),
        rng.randn(B, H, S, D).astype("f4"),
        rng.randn(B, H, S, D).astype("f4"),
        rng.randn(S, S).astype("f4"),
    )


def stacked_fn(x, gains, weights):
    """Pre-norm transformer-ish blocks in plain torch — mirrors
    ``stacked_transformer_graph`` (dots stay library calls: compile with
    ``fuse_dot=False``)."""
    for g, W in zip(gains, weights, strict=True):
        ms = torch.mean(torch.square(x), dim=1, keepdim=True)
        inv = torch.rsqrt(ms + 1e-6)
        normed = x * inv * g[None, :]
        x = x + F.silu(torch.matmul(normed, W))
    return x


def stacked_args(rng, num_layers: int = 8):
    B, D = 16, 64
    return (
        rng.randn(B, D).astype("f4"),
        [rng.randn(D).astype("f4") for _ in range(num_layers)],
        [rng.randn(D, D).astype("f4") for _ in range(num_layers)],
    )


def reduce_towers_fn(xs, ss):
    """Independent square/scale/reduce towers in plain torch — mirrors
    ``reduce_towers_graph`` (the horizontal-merge adversary)."""
    outs = []
    for x, s in zip(xs, ss, strict=True):
        e = torch.square(x * 0.5 + s)
        outs.append(torch.sum(e * e))
    return tuple(outs)


def reduce_towers_args(rng, num_towers: int = 6):
    B, D = 32, 64
    return (
        [rng.randn(B, D).astype("f4") for _ in range(num_towers)],
        [rng.randn(B, D).astype("f4") for _ in range(num_towers)],
    )


#: frontend-parity families: torch fn + example args + the hand-built
#: module it must reproduce + the StitchOptions overrides the frontend
#: compiles under (Stacked keeps its dots as library calls via
#: fuse_dot=False, matching the hand-built graph's ``fusable=False`` dots)
TORCH_FAMILIES = {
    "NMT": {"fn": nmt_fn, "args": nmt_args, "module": nmt_graph, "options": {}},
    "Stacked": {
        "fn": stacked_fn, "args": stacked_args,
        "module": stacked_transformer_graph, "options": {"fuse_dot": False},
    },
    "ReduceTowers": {
        "fn": reduce_towers_fn, "args": reduce_towers_args,
        "module": reduce_towers_graph, "options": {},
    },
}
