"""Stitched MoE router gate — the port of ``repro/kernels/stitched_moe_gate.py``.

softmax over experts, ``top_k`` argmax picks and the renormalisation of
the k weights in ONE hand-written CUDA kernel (``csrc/stitched_rowwise.cu``,
``sx_moe_gate_kernel``): a warp per token, the experts spread over its
lanes, 8 warps a block.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.device import input_device
from .cuda import DTYPE_SUFFIX, ROWWISE, HandKernel, check_sizes, check_tensor
from .ref import moe_gate_ref

KERNEL = HandKernel(
    "stitched_moe_gate", ROWWISE, "src/repro/kernels/stitched_moe_gate.py:53"
)

MAX_EXPERTS = 256   # eight logits a lane at most
MAX_TOP_K = 32      # lane r keeps pick r
GATE_WARPS = 8      # warps of one block, a token each (SX_GATE_WARPS)


def gate_grid(tokens: int, block_tokens: int) -> Tuple[int, int]:
    """(tokens per CUDA block, blocks) for ``tokens`` tokens: a warp per
    token and at most ``GATE_WARPS`` a block, fewer where ``block_tokens``
    (already shrunk to divide the tokens) is smaller.  The last block may
    be short; the kernel guards it."""
    per_block = min(block_tokens, GATE_WARPS)
    return per_block, -(-tokens // per_block)


def stitched_moe_gate(
    logits: torch.Tensor,       # (T, E)
    top_k: int,
    block_tokens: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, top_k) f32, indices (T, top_k) int32), by descending
    weight, ties to the lower index, NaN first (see ``moe_gate_ref``).

    ``block_tokens`` keeps the reference's signature and check: it is shrunk
    until it divides T.  It was the reference's TPU tile; on the card it
    only caps the tokens of one CUDA block, which holds ``GATE_WARPS`` = 8
    at most, a warp each (``gate_grid``), so the grid has at least T / 8
    blocks whatever its value: 512 at T = 4096."""
    name = KERNEL.name
    check_tensor(name, "logits", logits)
    if logits.dim() != 2 or logits.numel() == 0:
        raise ValueError(f"{name}: logits {tuple(logits.shape)}, expected a non-empty (T, E)")
    T, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"{name}: {E} experts; the kernel takes at most {MAX_EXPERTS}")
    if not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"{name}: top_k {top_k} not in [1, {min(E, MAX_TOP_K)}]")
    if block_tokens < 1:
        raise ValueError(f"{name}: block_tokens {block_tokens} < 1")
    check_sizes(name, tokens=T)
    bt = min(block_tokens, T)
    while T % bt:
        bt -= 1
    dev = input_device(name, [logits])
    if dev.type == "cpu":
        return moe_gate_ref(logits, top_k)
    ROWWISE.load()
    w = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    per_block, blocks = gate_grid(T, bt)
    KERNEL.launch(
        f"sx_moe_gate_{DTYPE_SUFFIX[logits.dtype]}", logits, w, idx, T, E, top_k, per_block,
        blocks, device=dev,
    )
    return w, idx
