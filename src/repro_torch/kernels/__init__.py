"""Hand-written CUDA kernels for Hopper — the port of ``repro/kernels``.

Each of the reference's five Pallas kernels is a kernel written by hand
in CUDA C++ for ``sm_90a`` (``csrc/stitched_rowwise.cu``,
``csrc/stitched_attention.cu``), built at first use: <name>.py holds the
wrapper and its launch counter, ops.py the public wrappers, ref.py the
plain PyTorch versions that CPU tensors run and the card is checked
against.
"""
from . import ops, ref
from .ops import attention, attention_decode, moe_gate, rmsnorm, softmax

__all__ = ["ops", "ref", "attention", "attention_decode", "moe_gate", "rmsnorm", "softmax"]
