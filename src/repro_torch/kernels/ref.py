"""Plain PyTorch versions of the hand-written kernels — the port of
``repro/kernels/ref.py``.

Each computes in f32 and casts once at the end, as the reference's oracles
do.  A kernel wrapper runs them for CPU tensors, the CPU tests hold them
against ``repro.kernels``, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def softmax_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically-stable softmax (the paper's Fig.-3 exp/reduce/div chain)."""
    x32 = x.float()
    m = torch.amax(x32, dim=axis, keepdim=True)
    e = torch.exp(x32 - m)
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def _softmax_rows(s: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    # jax.nn.softmax over -inf-masked scores: an all-masked row is NaN
    return torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)


def attention_ref(
    q: torch.Tensor,            # (B, Hq, S, D)
    k: torch.Tensor,            # (B, Hkv, S, D)
    v: torch.Tensor,            # (B, Hkv, S, D)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    S, D = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kk = k.float().repeat_interleave(G, dim=1)
    vv = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        p = _softmax_rows(s, torch.ones(S, S, dtype=torch.bool, device=q.device).tril())
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, Hkv, S, D)  KV cache
    v: torch.Tensor,            # (B, Hkv, S, D)
    lengths: torch.Tensor,      # (B,) int32 valid cache lengths
    scale: Optional[float] = None,
) -> torch.Tensor:
    S, D = k.shape[2], q.shape[2]
    G = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kk = k.float().repeat_interleave(G, dim=1)
    vv = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * scale
    keep = torch.arange(S, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    p = _softmax_rows(s, keep)
    return torch.einsum("bhk,bhkd->bhd", p, vv).to(q.dtype)


def moe_gate_ref(
    logits: torch.Tensor,       # (T, E)
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: softmax over experts, take top-k, renormalize the k weights.

    Returns (weights (T, k) f32, indices (T, k) int32), as the Pallas
    kernel computes them (``repro/kernels/stitched_moe_gate.py:18-39``):
    ``top_k`` rounds of an argmax in which NaN ranks above every number
    and the lower index wins ties, each round lowering its pick by 2.0,
    then the weights divided by their sum, added in pick order.  A row
    with a NaN or +inf logit, or of -inf logits only, is NaN after the
    softmax, so its picks are index 0, k times, with NaN weights.
    """
    cur = softmax_ref(logits.float())
    rows = torch.arange(cur.shape[0], device=cur.device)
    total = torch.zeros(cur.shape[0], dtype=torch.float32, device=cur.device)
    picks_w, picks_i = [], []
    for _ in range(top_k):
        nan = cur.isnan()
        # argmax returns the first of equal maxima; a NaN ranks above all
        i = torch.where(nan.any(-1), nan.to(torch.uint8).argmax(-1), cur.argmax(-1))
        w = cur[rows, i]
        picks_w.append(w)
        picks_i.append(i)
        total = total + w
        cur = cur.index_put((rows, i), w - 2.0)
    w = torch.stack(picks_w, dim=-1) / total[:, None]
    return w, torch.stack(picks_i, dim=-1).to(torch.int32)
