"""Stitched attention — the port of ``repro/kernels/stitched_attention.py``.

The reference streams KV blocks through VMEM along a sequential grid axis
and carries the online-softmax state (m, l, acc) in scratch from one grid
step to the next.  CUDA blocks run in no order and carry nothing, so in
the two hand-written kernels (``csrc/stitched_attention.cu``) the KV loop
runs inside each block:

  * ``flash_attention`` — prefill: one block per (q tile, query head,
    sequence), one thread per query row, K/V tiles staged in shared memory;
    causal tiles wholly above the diagonal are skipped.
  * ``decode_attention`` — one new token per sequence against a KV cache
    with per-sequence valid ``lengths``: one block per (query head,
    sequence), each warp an online softmax over its runs of keys, merged at
    the end.

GQA maps query head h to kv head h // (Hq // Hkv).  All arithmetic is f32
whatever the I/O dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import input_device
from .cuda import ATTENTION, DTYPE_SUFFIX, HandKernel, check_tensor
from .ref import attention_ref, decode_attention_ref

FLASH = HandKernel(
    "stitched_flash_attention", ATTENTION, "src/repro/kernels/stitched_attention.py:103"
)
DECODE = HandKernel(
    "stitched_decode_attention", ATTENTION, "src/repro/kernels/stitched_attention.py:183"
)

HEAD_DIMS = (8, 16, 32, 64, 128)   # the head dims the kernels are instantiated for
MAX_BLOCK_Q = 256                  # SX_FLASH_MAX_BQ: one thread per query row
SMEM_BYTES = 232_448               # shared memory one block may use on Hopper


def _check_qkv(name: str, q, k, v, q_dims: int) -> None:
    check_tensor(name, "q", q)
    for what, t in (("k", k), ("v", v)):
        check_tensor(name, what, t, dtypes=(q.dtype,))
    if q.dim() != q_dims or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    B, Hq, D = q.shape[0], q.shape[1], q.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, D) or k.numel() == 0 or q.numel() == 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if Hq % k.shape[1]:
        raise ValueError(f"{name}: {Hq} query heads are not a multiple of {k.shape[1]} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}; the kernels take {HEAD_DIMS}")


def flash_attention(
    q: torch.Tensor,               # (B, Hq, S, D)
    k: torch.Tensor,               # (B, Hkv, S, D)
    v: torch.Tensor,               # (B, Hkv, S, D)
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Prefill attention, causal or not, in tiles of ``block_q`` query rows
    and ``block_k`` keys; S must be a multiple of both."""
    name = FLASH.name
    _check_qkv(name, q, k, v, 4)
    B, Hq, S, D = q.shape
    if k.shape[2] != S:
        raise ValueError(f"{name}: q has {S} positions, k {k.shape[2]}")
    scale = scale if scale is not None else D ** -0.5
    bq, bk = min(block_q, S), min(block_k, S)
    if bq < 1 or bk < 1 or S % bq or S % bk:
        raise ValueError(f"{name}: S {S} is not a multiple of block_q {bq} and block_k {bk}")
    if bq > MAX_BLOCK_Q:
        raise ValueError(f"{name}: block_q {bq} > {MAX_BLOCK_Q} query rows per block")
    if 2 * 4 * bk * D > SMEM_BYTES:
        raise ValueError(f"{name}: K and V tiles of {bk}x{D} f32 exceed {SMEM_BYTES} bytes")
    dev = input_device(name, [q, k, v])
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    ATTENTION.load()
    o = torch.empty_like(q)
    FLASH.launch(
        f"sx_flash_attention_{DTYPE_SUFFIX[q.dtype]}", q, k, v, o,
        B, Hq, k.shape[1], S, D, bq, bk, int(bool(causal)), float(scale), device=dev,
    )
    return o


def decode_attention(
    q: torch.Tensor,               # (B, Hq, D) — one new token per sequence
    k: torch.Tensor,               # (B, Hkv, S, D) KV cache
    v: torch.Tensor,               # (B, Hkv, S, D)
    lengths: torch.Tensor,         # (B,) int32 valid lengths
    scale: Optional[float] = None,
    block_k: int = 256,
) -> torch.Tensor:
    """Attention of one query token per sequence over the first
    ``lengths[b]`` keys of its cache; NaN where ``lengths[b] == 0``, as in
    the reference.  ``block_k`` keeps the reference's signature and its
    check that it divides S; the kernel's warps walk the keys in runs of 32
    whatever its value."""
    name = DECODE.name
    _check_qkv(name, q, k, v, 3)
    check_tensor(name, "lengths", lengths, dtypes=(torch.int32,))
    B, Hq, D = q.shape
    S = k.shape[2]
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)}, expected ({B},)")
    scale = scale if scale is not None else D ** -0.5
    bk = min(block_k, S)
    if bk < 1 or S % bk:
        raise ValueError(f"{name}: S {S} is not a multiple of block_k {bk}")
    dev = input_device(name, [q, k, v, lengths])
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale)
    ATTENTION.load()
    o = torch.empty_like(q)
    DECODE.launch(
        f"sx_decode_attention_{DTYPE_SUFFIX[q.dtype]}", q, k, v, lengths, o,
        B, Hq, k.shape[1], S, D, float(scale), device=dev,
    )
    return o
