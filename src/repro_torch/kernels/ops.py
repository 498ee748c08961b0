"""Public wrappers for the hand-written kernels — the port of
``repro/kernels/ops.py``.

The same names as the reference.  Each runs its CUDA kernel on CUDA
tensors and its plain version on CPU tensors, and refuses any other
device; the reference's ``interpret``, ``on_tpu`` and
``default_interpret`` have no counterpart.  ``KERNELS`` holds each
kernel's ``HandKernel`` (its launch counter) by name.
"""
from __future__ import annotations

from . import stitched_attention as _attention
from . import stitched_moe_gate as _moe_gate
from . import stitched_rmsnorm as _rmsnorm
from . import stitched_softmax as _softmax
from .ref import (
    attention_ref,
    decode_attention_ref,
    moe_gate_ref,
    rmsnorm_ref,
    softmax_ref,
)
from .stitched_attention import decode_attention, flash_attention
from .stitched_moe_gate import stitched_moe_gate
from .stitched_rmsnorm import stitched_rmsnorm
from .stitched_softmax import stitched_softmax

KERNELS = {
    k.name: k
    for k in (_rmsnorm.KERNEL, _softmax.KERNEL, _attention.FLASH, _attention.DECODE,
              _moe_gate.KERNEL)
}


softmax = stitched_softmax
rmsnorm = stitched_rmsnorm
attention = flash_attention
attention_decode = decode_attention
moe_gate = stitched_moe_gate

__all__ = [
    "softmax", "rmsnorm", "attention", "attention_decode", "moe_gate",
    "softmax_ref", "rmsnorm_ref", "attention_ref", "decode_attention_ref",
    "moe_gate_ref", "flash_attention", "decode_attention",
    "stitched_softmax", "stitched_rmsnorm", "stitched_moe_gate", "KERNELS",
]
