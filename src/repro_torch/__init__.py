"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The same StitchIR, the same pass pipeline and the same planner decisions
as the JAX reference, with the two Pallas code generators rewritten as
CUDA C++ generators (``core/codegen.py``, built by ``core/cuda_build.py``).
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs its plain PyTorch version.
``stitch`` (``frontend/``) captures a PyTorch function into StitchIR and
compiles it per input signature, as ``repro.stitch`` does a JAX function.
``configs`` and ``models`` hold the architectures and the LM stack (forward,
slot and paged decode) in plain torch ops; ``serve`` the serving engines
over them, each step replayed from a CUDA graph on the card
(``python -m repro_torch.launch.serve``); ``train``, ``data`` and
``checkpoint`` the optimizer, the losses, the train steps and the
fault-tolerant ``Trainer``, each step captured once as a CUDA graph on the
card (``python -m repro_torch.launch.train``).
The package imports torch and numpy, never jax and nothing of ``repro``.

``__all__`` holds ``repro.__all__``'s names, then the port's own.  The
reference's deprecated flat names resolve, with a one-time
``DeprecationWarning``, to their homes in the port, through the port's
analogue where the reference's name is JAX's (``lower_jaxpr`` is
``frontend.lower_graph``, ``SUPPORTED_PRIMITIVES`` is
``frontend.SUPPORTED_OPS``).
"""
import warnings as _warnings

__version__ = "1.2.0"

from .core import (  # noqa: E402,F401
    CompiledModule,
    CompileStats,
    Diagnostic,
    GraphBuilder,
    Module,
    StitchOptions,
    VerificationError,
    compile_module,
    reference_execute,
)
from . import checkpoint, configs, data, models, serve, train  # noqa: E402,F401
from .frontend import (  # noqa: E402,F401
    SUPPORTED_OPS,
    CostEstimate,
    Lowered,
    StitchedFunction,
    UnsupportedPrimitiveError,
    lower_graph,
    stitch,
)
from .serve import BaseEngine, PagedServeEngine, Request, ServeEngine  # noqa: E402,F401

__all__ = [
    # frontend
    "stitch",
    "StitchOptions",
    "StitchedFunction",
    "Lowered",
    "CostEstimate",
    "UnsupportedPrimitiveError",
    # compiler core
    "CompiledModule",
    "CompileStats",
    "Module",
    "compile_module",
    # verification (core/verify.py)
    "Diagnostic",
    "VerificationError",
    # serving
    "BaseEngine",
    "ServeEngine",
    "PagedServeEngine",
    "Request",
    # the port's own
    "GraphBuilder",
    "reference_execute",
    "lower_graph",
    "SUPPORTED_OPS",
    "checkpoint",
    "configs",
    "data",
    "models",
    "serve",
    "train",
]

# The reference's pre-1.2 flat names that the port does not export directly:
# each resolves to its home in the port and warns once per process.
_DEPRECATED = {
    "trace": ("repro_torch.core", "trace"),
    "lower_jaxpr": ("repro_torch.frontend", "lower_graph"),
    "SUPPORTED_PRIMITIVES": ("repro_torch.frontend", "SUPPORTED_OPS"),
}
_warned: set = set()


def __getattr__(name):
    if name in _DEPRECATED:
        mod_name, attr = _DEPRECATED[name]
        if name not in _warned:
            _warned.add(name)
            _warnings.warn(
                f"importing {name!r} from 'repro_torch' is deprecated; use "
                f"'from {mod_name} import {attr}' instead",
                DeprecationWarning,
                stacklevel=2,
            )
        import importlib

        return getattr(importlib.import_module(mod_name), attr)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(_DEPRECATED) | set(globals()))
