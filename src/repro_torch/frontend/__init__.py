"""The port's frontend: ``stitch`` over PyTorch functions — the counterpart
of ``repro/frontend``.

``stitch(fn)`` captures ``fn`` into an ATen graph (``api.capture``),
lowers it into StitchIR (``aten_lower.lower_graph``) and compiles it with
the port's ``compile_module``, one plan per input signature; under
``mesh=`` the per-shard body goes through ``lower_sharded_graph``.  The op
tables (``*_OPS``) are the analogues of the reference's primitive tables
(``*_PRIMS``; ``CALL_PRIMS`` is ``CONTROL_FLOW_OPS``).  Imports
torch and numpy, never jax and nothing of ``repro``.
"""
from .api import CostEstimate, Lowered, StitchedFunction, capture, stitch
from .aten_lower import (
    BINARY_OPS,
    COLLECTIVE_OPS,
    CONTROL_FLOW_OPS,
    IDENTITY_OPS,
    REDUCE_OPS,
    STRUCTURAL_OPS,
    SUPPORTED_OPS,
    UNARY_OPS,
    LoweredGraph,
    LoweredShardedGraph,
    UnsupportedPrimitiveError,
    lower_graph,
    lower_sharded_graph,
)

__all__ = [
    "BINARY_OPS",
    "COLLECTIVE_OPS",
    "CONTROL_FLOW_OPS",
    "CostEstimate",
    "IDENTITY_OPS",
    "Lowered",
    "LoweredGraph",
    "LoweredShardedGraph",
    "REDUCE_OPS",
    "STRUCTURAL_OPS",
    "StitchedFunction",
    "SUPPORTED_OPS",
    "UNARY_OPS",
    "UnsupportedPrimitiveError",
    "capture",
    "lower_graph",
    "lower_sharded_graph",
    "stitch",
]
