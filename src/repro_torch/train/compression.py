"""Gradient compression for the cross-pod all-reduce, the reference's
``repro/train/compression.py`` in torch.

Two composable transforms:

  * bf16 reduction — cast grads to bf16 before the all-reduce, accumulate
    back in f32 (2x bytes saved on the wire);
  * int8 error-feedback — per-tensor symmetric int8 quantization with a
    residual carried to the next step (1-bit-Adam-style EF), 4x bytes
    saved; the residual compensates the quantization error.

Trees are nested dicts of tensors, as the params are.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..models.module import tree_map
from .optimizer import tree_leaves_sorted

F32 = torch.float32


class EFState(NamedTuple):
    residual: Any            # f32 tree like grads


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params))


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.round`` rounds half to even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_int8_ef(grads, state: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (tree of (q, scale) pairs for the wire, dequantized grads for
    the local update path, new EF state)."""
    def one(g, r):
        x = g.to(F32) + r
        q, s = _quantize_int8(x)
        d = _dequantize_int8(q, s)
        return (q, s), d, x - d

    outs = tree_map(one, grads, state.residual)
    wire = tree_map(lambda o: o[0], outs)
    deq = tree_map(lambda o: o[1], outs)
    res = tree_map(lambda o: o[2], outs)
    return wire, deq, EFState(res)


def bf16_compress(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def bf16_decompress(grads):
    return tree_map(lambda g: g.to(F32), grads)


def _wire_leaves(tree):
    """Leaves of dicts, tuples and lists (the wire tree's (q, scale) pairs
    included)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _wire_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _wire_leaves(v)]
    return tree_leaves_sorted(tree)


def wire_bytes(tree) -> int:
    total = 0
    for leaf in _wire_leaves(tree):
        if hasattr(leaf, "shape"):
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    return total
