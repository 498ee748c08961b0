"""Stitched RMSNorm — the port of ``repro/kernels/stitched_rmsnorm.py``.

square / mean-reduce / rsqrt / mul / mul in ONE hand-written CUDA kernel
(``csrc/stitched_rowwise.cu``).  ``sx_rmsnorm_vec_kernel`` (launchers
``sx_rmsnorm_vec_{f32,bf16,f16}``) reads x once in 16-byte words and holds each
row in registers between the mean square and the write; its grid fills the
card and each row group loads gamma once.  Rows it cannot serve take
``sx_rmsnorm_kernel`` (launchers ``sx_rmsnorm_{f32,bf16,f16}``), the row layout
of the softmax kernel, which reads x twice: rows whose bytes are not a
multiple of 16, x or gamma not 16-byte aligned, or rows wider than
``MAX_HELD_ROW_BYTES``.  The wrapper chooses from shapes and pointers
before the launch (``vector_warps``), so every d is taken, as by the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import input_device
from .cuda import DTYPE_SUFFIX, ROWWISE, HandKernel, check_sizes, check_tensor
from .ref import rmsnorm_ref
from .stitched_softmax import flat_rows, row_threads, rows_per_block

KERNEL = HandKernel(
    "stitched_rmsnorm", ROWWISE, "src/repro/kernels/stitched_rmsnorm.py:43"
)

VEC_BYTES = 16      # one access of the 16-byte kernel
VEC_THREADS = 256   # threads of one of its blocks (SX_RMS_THREADS)
VEC_PER_LANE = 8    # 16-byte words a lane holds, at most (the launcher's VPL)
#: the widest row the 16-byte kernel holds in registers: a group of 8 warps,
#: 8 words a lane, i.e. 32 KB (d = 16,384 in bf16 or f16, 8,192 in f32)
MAX_HELD_ROW_BYTES = VEC_THREADS * VEC_PER_LANE * VEC_BYTES


def vector_warps(x: torch.Tensor, gamma: torch.Tensor, cols: int) -> Optional[int]:
    """The warps that own a row in the 16-byte kernel (1, 2, 4 or 8: the
    fewest that hold it at ``VEC_PER_LANE`` words a lane), or None where
    that kernel cannot serve these rows."""
    row_bytes = cols * x.element_size()
    if (row_bytes % VEC_BYTES or row_bytes > MAX_HELD_ROW_BYTES
            or x.data_ptr() % VEC_BYTES or gamma.data_ptr() % VEC_BYTES):
        return None
    words, warps = row_bytes // VEC_BYTES, 1
    while words > 32 * warps * VEC_PER_LANE:
        warps *= 2
    return warps


def stitched_rmsnorm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    eps: float = 1e-6,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """RMSNorm over the last dim.  ``block_rows`` keeps the reference's
    check (one of ``ROWS_PER_BLOCK``, dividing the rows) and is the rows
    of one block of the scalar kernel; the 16-byte kernel takes it as a cap
    on the rows its 256-thread blocks hold at a time."""
    check_tensor(KERNEL.name, "x", x)
    check_tensor(KERNEL.name, "gamma", gamma, dtypes=(x.dtype,))
    rows, cols = flat_rows(KERNEL.name, x)
    if tuple(gamma.shape) != (cols,):
        raise ValueError(f"{KERNEL.name}: gamma {tuple(gamma.shape)}, expected ({cols},)")
    check_sizes(KERNEL.name, rows=rows, cols=cols)
    br = rows_per_block(KERNEL.name, rows, cols, block_rows)
    dev = input_device(KERNEL.name, [x, gamma])
    if dev.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    ROWWISE.load()
    y = torch.empty_like(x)
    sfx = DTYPE_SUFFIX[x.dtype]
    warps = vector_warps(x, gamma, cols)
    if warps is None:
        KERNEL.launch(
            f"sx_rmsnorm_{sfx}", x, gamma, y, rows, cols, br, row_threads(cols, br),
            float(eps), device=dev,
        )
    else:
        held = VEC_THREADS // (32 * warps)
        KERNEL.launch(
            f"sx_rmsnorm_vec_{sfx}", x, gamma, y, rows, cols, warps,
            min(held, block_rows or held), float(eps), device=dev,
        )
    return y
