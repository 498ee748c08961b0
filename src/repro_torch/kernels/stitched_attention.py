"""Stitched attention — the port of ``repro/kernels/stitched_attention.py``.

The reference streams KV blocks through VMEM along a sequential grid axis
and carries the online-softmax state (m, l, acc) in scratch from one grid
step to the next.  CUDA blocks run in no order and carry nothing, so in
the hand-written kernels (``csrc/stitched_attention.cu``) the KV loop runs
inside each block:

  * ``flash_attention`` — prefill, bound by operations.  bf16 and f16 run
    ``sx_flash_mma_kernel``: both products on the tensor cores (``mma.sync``
    m16n8k16 in its bf16 or f16 form, f32 sums), a block of 4 warps per 64
    query rows, K/V
    tiles of 64 keys double-buffered in shared memory by ``cp.async``, the
    heaviest causal q tiles first.  f32 runs ``sx_flash_kernel`` (one
    thread per query row, f32 FMAs): the tensor cores at f32 would be TF32,
    outside the f32 limits.  Causal tiles wholly above the diagonal
    are skipped by both.  One launch per call.
  * ``decode_attention`` — one new token per sequence against a KV cache
    with per-sequence valid ``lengths``, bound by bytes.  Two launches per
    call: ``sx_decode_split_kernel``, one block per (split of
    ``DECODE_SPLIT`` keys, kv head, sequence) serving all G query heads of
    its kv head, so each valid key and value row is read once, with
    16-byte loads; then ``sx_decode_combine_kernel`` merges the splits'
    (acc, m, l) from an f32 scratch whose shape follows S alone.
    ``lengths`` stays on the card: the wrapper never reads it.

GQA maps query head h to kv head h // (Hq // Hkv).  All sums are f32
whatever the I/O dtype; bf16 and f16 flash give the tensor cores the
softmax weights as two terms of their type (hi + lo), which keeps about 16
bits of each in bf16 and more in f16.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
MAX_BLOCK_Q = 256                  # SX_FLASH_MAX_BQ: one thread per query row (f32 flash)
SMEM_BYTES = 232_448               # shared memory one block may use on Hopper
DECODE_SPLIT = 256                 # SX_DECODE_MAX_SPLIT: keys of one decode split at most
ALIGN = 16                         # bytes: the kernels read rows with 16-byte loads


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


def _check_aligned(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {what} is not {ALIGN}-byte aligned")


def decode_splits(S: int) -> Tuple[int, int]:
    """Keys per split and the number of splits of decode's first kernel:
    a function of the cache length S alone, so the scratch's shape never
    depends on ``lengths``, which stays on the card."""
    split = min(DECODE_SPLIT, S)
    return split, -(-S // split)


def flash_attention(
    q: torch.Tensor,               # (B, Hq, S, D)
    k: torch.Tensor,               # (B, Hkv, S, D)
    v: torch.Tensor,               # (B, Hkv, S, D)
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Prefill attention, causal or not.  ``block_q`` and ``block_k`` keep
    the reference's signature and its check that S is a multiple of both;
    they size the tiles of the f32 kernel only.  The bf16 and f16 kernel takes 64
    query rows and 64 keys at a time whatever their value, and masks an S
    that is not a multiple of 64."""
    name = FLASH.name
    _check_qkv(name, q, k, v, 4)
    B, Hq, S, D = q.shape
    if k.shape[2] != S:
        raise ValueError(f"{name}: q has {S} positions, k {k.shape[2]}")
    scale = scale if scale is not None else D ** -0.5
    bq, bk = min(block_q, S), min(block_k, S)
    if bq < 1 or bk < 1 or S % bq or S % bk:
        raise ValueError(f"{name}: S {S} is not a multiple of block_q {bq} and block_k {bk}")
    if q.dtype == torch.float32:
        if bq > MAX_BLOCK_Q:
            raise ValueError(f"{name}: block_q {bq} > {MAX_BLOCK_Q} query rows per block")
        if 2 * 4 * bk * D > SMEM_BYTES:
            raise ValueError(f"{name}: K and V tiles of {bk}x{D} f32 exceed {SMEM_BYTES} bytes")
    dev = input_device(name, [q, k, v])
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    ATTENTION.load()
    o = torch.empty_like(q)
    if q.dtype in (torch.bfloat16, torch.float16):  # the tensor cores
        _check_aligned(name, q=q, k=k, v=v, o=o)
        FLASH.launch(
            f"sx_flash_mma_attention_{DTYPE_SUFFIX[q.dtype]}", q, k, v, o,
            B, Hq, k.shape[1], S, D, int(bool(causal)), float(scale), device=dev,
        )
    else:  # f32 FMAs on the CUDA cores
        FLASH.launch(
            "sx_flash_attention_f32", q, k, v, o,
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
    check that it divides S; the kernels split the cache into
    ``decode_splits(S)`` whatever its value."""
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
    _check_aligned(name, k=k, v=v)
    split, nsplit = decode_splits(S)
    # each (sequence, query head, split): acc[D], then m and l
    part = torch.empty((B, Hq, nsplit, D + 2), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    sfx = DTYPE_SUFFIX[q.dtype]
    DECODE.launch(
        f"sx_decode_split_{sfx}", q, k, v, lengths, part,
        B, Hq, k.shape[1], S, D, split, nsplit, float(scale), device=dev,
    )
    DECODE.launch(f"sx_decode_combine_{sfx}", part, o, B, Hq, D, nsplit, device=dev)
    return o
