"""Stitched softmax — the port of ``repro/kernels/stitched_softmax.py``.

The max-reduce / exp / sum-reduce / divide chain over the last dim as ONE
hand-written CUDA kernel launch (``csrc/stitched_rowwise.cu``).  Leading
dims are flattened into rows, and the wrapper picks the kernel before the
launch (``cluster_slice``):

* rows of ``CLUSTER_MIN_COLS`` to ``CLUSTER_MAX_COLS`` columns, with
  ``block_rows`` left to the wrapper, take ``sx_softmax_cluster_kernel``
  (launchers ``sx_softmax_cluster_{f32,bf16,f16}``): a cluster of
  ``CLUSTER_BLOCKS`` blocks owns a row, each block reads its slice once
  and the blocks merge their (max, sum) pairs through distributed shared
  memory;
* every other row takes ``sx_softmax_kernel`` (launchers
  ``sx_softmax_{f32,bf16,f16}``): a group of threads owns each row, and a block
  holds ``rows_per_block`` rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.device import input_device
from .cuda import DTYPE_SUFFIX, ROWWISE, HandKernel, check_tensor
from .ref import softmax_ref

KERNEL = HandKernel(
    "stitched_softmax", ROWWISE, "src/repro/kernels/stitched_softmax.py:53"
)

#: rows one CUDA block can hold: each row needs a group of at least a warp
ROWS_PER_BLOCK = (1, 2, 4, 8, 16, 32)
#: columns per warp a row group aims at, up to 1024 threads in the block
COLS_PER_WARP = 256

#: blocks of one row's cluster (8, the portable maximum: 16 rows fill 128
#: of the 132 SMs), threads of each (SX_SOFTMAX_CLUSTER_THREADS) and values
#: a thread holds at most (the launcher's largest EPT)
CLUSTER_BLOCKS = 8
CLUSTER_THREADS = 512
CLUSTER_MAX_PER_THREAD = 32
#: narrower rows pack several to a block instead (under a value a thread)
CLUSTER_MIN_COLS = CLUSTER_BLOCKS * CLUSTER_THREADS
#: the widest row one cluster holds in registers
CLUSTER_MAX_COLS = CLUSTER_BLOCKS * CLUSTER_THREADS * CLUSTER_MAX_PER_THREAD


def cluster_slice(cols: int, block_rows: Optional[int]) -> Optional[int]:
    """The columns each block of the cluster kernel owns, or None where the
    row kernel serves these rows: an explicit ``block_rows``, or rows
    outside ``CLUSTER_MIN_COLS``..``CLUSTER_MAX_COLS``."""
    if block_rows is not None or not CLUSTER_MIN_COLS <= cols <= CLUSTER_MAX_COLS:
        return None
    return -(-cols // CLUSTER_BLOCKS)


def row_threads(cols: int, rows_per_block: int) -> int:
    """Threads of one block: per row a group of one warp per
    ``COLS_PER_WARP`` columns, at least one and at most what 1024 threads
    leave each row."""
    warps = min(max(1, -(-cols // COLS_PER_WARP)), 32 // rows_per_block)
    return 32 * warps * rows_per_block


def rows_per_block(name: str, rows: int, cols: int, block_rows: Optional[int]) -> int:
    """The rows of one CUDA block.  ``block_rows=None`` picks as many as
    keep one warp per row busy (``1024 // cols``, at most 8), halved until
    they divide ``rows``.  An explicit value must be one of
    ``ROWS_PER_BLOCK`` and divide ``rows``; else ``ValueError``."""
    if block_rows is None:
        br = 8
        while br > 1 and (br * cols > 1024 or rows % br):
            br //= 2
        return br
    if block_rows not in ROWS_PER_BLOCK:
        raise ValueError(f"{name}: block_rows {block_rows}: the kernel takes {ROWS_PER_BLOCK}")
    if rows % block_rows:
        raise ValueError(f"{name}: rows {rows} % block_rows {block_rows} != 0")
    return block_rows


def flat_rows(name: str, x: torch.Tensor) -> Tuple[int, int]:
    """``x`` as (rows, cols) over its last dim; raises on an empty ``x``."""
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: input of shape {tuple(x.shape)} has no rows")
    cols = x.shape[-1]
    return x.numel() // cols, cols


def stitched_softmax(x: torch.Tensor, block_rows: Optional[int] = None) -> torch.Tensor:
    """Softmax over the last dim; leading dims are flattened into rows."""
    check_tensor(KERNEL.name, "x", x)
    rows, cols = flat_rows(KERNEL.name, x)
    br = rows_per_block(KERNEL.name, rows, cols, block_rows)
    dev = input_device(KERNEL.name, [x])
    if dev.type == "cpu":
        return softmax_ref(x)
    ROWWISE.load()
    y = torch.empty_like(x)
    sfx = DTYPE_SUFFIX[x.dtype]
    slice_cols = cluster_slice(cols, block_rows)
    if slice_cols is not None:
        KERNEL.launch(f"sx_softmax_cluster_{sfx}", x, y, rows, cols, CLUSTER_BLOCKS, slice_cols,
                      device=dev)
    else:
        KERNEL.launch(f"sx_softmax_{sfx}", x, y, rows, cols, br, row_threads(cols, br), device=dev)
    return y
