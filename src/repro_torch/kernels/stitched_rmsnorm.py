"""Stitched RMSNorm — the port of ``repro/kernels/stitched_rmsnorm.py``.

square / mean-reduce / rsqrt / mul / mul in ONE hand-written CUDA kernel
(``csrc/stitched_rowwise.cu``, ``sx_rmsnorm_kernel``), on the row layout
of the softmax kernel: a group of threads owns each row, the mean square
never leaves the chip, and the normalised product with the gain is
written in the same pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import input_device
from .cuda import DTYPE_SUFFIX, ROWWISE, HandKernel, check_tensor
from .ref import rmsnorm_ref
from .stitched_softmax import flat_rows, row_threads, rows_per_block

KERNEL = HandKernel(
    "stitched_rmsnorm", ROWWISE, "src/repro/kernels/stitched_rmsnorm.py:43"
)


def stitched_rmsnorm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    eps: float = 1e-6,
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    check_tensor(KERNEL.name, "x", x)
    check_tensor(KERNEL.name, "gamma", gamma, dtypes=(x.dtype,))
    rows, cols = flat_rows(KERNEL.name, x)
    if tuple(gamma.shape) != (cols,):
        raise ValueError(f"{KERNEL.name}: gamma {tuple(gamma.shape)}, expected ({cols},)")
    br = rows_per_block(KERNEL.name, rows, cols, block_rows)
    dev = input_device(KERNEL.name, [x, gamma])
    if dev.type == "cpu":
        return rmsnorm_ref(x, gamma, eps)
    ROWWISE.load()
    y = torch.empty_like(x)
    KERNEL.launch(
        f"sx_rmsnorm_{DTYPE_SUFFIX[x.dtype]}", x, gamma, y, rows, cols, br,
        row_threads(cols, br), float(eps), device=dev,
    )
    return y
