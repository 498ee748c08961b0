"""The port's frontend: ``stitch`` over PyTorch functions — the counterpart
of ``repro/frontend``.

``stitch(fn)`` captures ``fn`` into an ATen graph (``api.capture``),
lowers it into StitchIR (``aten_lower.lower_graph``) and compiles it with
the port's ``compile_module``, one plan per input signature.  Imports
torch and numpy, never jax and nothing of ``repro``.
"""
from .api import CostEstimate, Lowered, StitchedFunction, capture, stitch
from .aten_lower import (
    CONTROL_FLOW_OPS,
    SUPPORTED_OPS,
    LoweredGraph,
    UnsupportedPrimitiveError,
    lower_graph,
)

__all__ = [
    "CONTROL_FLOW_OPS",
    "CostEstimate",
    "Lowered",
    "LoweredGraph",
    "StitchedFunction",
    "SUPPORTED_OPS",
    "UnsupportedPrimitiveError",
    "capture",
    "lower_graph",
    "stitch",
]
